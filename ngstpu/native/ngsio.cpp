// ngsio — native host-side I/O runtime for ngstpu.
//
// Plays the role the reference delegates to klib kseq + zlib gzgets loops
// (reference klib/kseq.h:143-226, fastq_trim.c:67-89) and the kt_for thread
// pool (reference klib/kthread.c:48-60): high-throughput byte scanning and
// padded-tensor assembly on the host, feeding fixed-shape device buffers.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// All functions are thread-parallel internally where it pays.
//
// Build: ngstpu/io/native.py compiles this on first import with g++ -O3.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <algorithm>
#include <array>
#include <atomic>
#include <thread>
#include <vector>

#include <zlib.h>
#include <dlfcn.h>

namespace {

// libdeflate (when present on the system) inflates gzip members ~2-3x
// faster than zlib — the decisive lever for BGZF/BAM decode throughput on
// a low-core host. Loaded lazily via dlopen so the build never depends on
// it; every call site falls back to the zlib path on absence or error.
struct LibDeflate {
    void* (*alloc_decompressor)(void) = nullptr;
    void (*free_decompressor)(void*) = nullptr;
    // enum libdeflate_result (0 == LIBDEFLATE_SUCCESS)
    int (*gzip_decompress_ex)(void*, const void*, size_t, void*, size_t,
                              size_t*, size_t*) = nullptr;
    // raw-DEFLATE payload decode: skips the gzip wrapper parse AND the
    // mandatory whole-output CRC32 the gzip entry point pays — callers
    // that already validated the member framing (BGZF's host-side header
    // scan) opt into it, with CRC verification available on demand.
    int (*deflate_decompress_ex)(void*, const void*, size_t, void*, size_t,
                                 size_t*, size_t*) = nullptr;
    uint32_t (*crc32)(uint32_t, const void*, size_t) = nullptr;
    // compression side (~2-4x faster than zlib deflate at equal levels;
    // used by the parallel multi-member gzip writer)
    void* (*alloc_compressor)(int) = nullptr;
    void (*free_compressor)(void*) = nullptr;
    size_t (*gzip_compress)(void*, const void*, size_t, void*,
                            size_t) = nullptr;
    bool ok = false;
};

const LibDeflate& libdeflate() {
    static const LibDeflate ld = [] {
        LibDeflate l;
        void* h = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_LOCAL);
        if (!h) h = dlopen("libdeflate.so", RTLD_NOW | RTLD_LOCAL);
        if (!h) return l;
        l.alloc_decompressor = reinterpret_cast<void* (*)(void)>(
            dlsym(h, "libdeflate_alloc_decompressor"));
        l.free_decompressor = reinterpret_cast<void (*)(void*)>(
            dlsym(h, "libdeflate_free_decompressor"));
        l.gzip_decompress_ex =
            reinterpret_cast<int (*)(void*, const void*, size_t, void*,
                                     size_t, size_t*, size_t*)>(
                dlsym(h, "libdeflate_gzip_decompress_ex"));
        l.deflate_decompress_ex =
            reinterpret_cast<int (*)(void*, const void*, size_t, void*,
                                     size_t, size_t*, size_t*)>(
                dlsym(h, "libdeflate_deflate_decompress_ex"));
        l.crc32 = reinterpret_cast<uint32_t (*)(uint32_t, const void*,
                                                size_t)>(
            dlsym(h, "libdeflate_crc32"));
        l.alloc_compressor = reinterpret_cast<void* (*)(int)>(
            dlsym(h, "libdeflate_alloc_compressor"));
        l.free_compressor = reinterpret_cast<void (*)(void*)>(
            dlsym(h, "libdeflate_free_compressor"));
        l.gzip_compress =
            reinterpret_cast<size_t (*)(void*, const void*, size_t, void*,
                                        size_t)>(
                dlsym(h, "libdeflate_gzip_compress"));
        l.ok = l.alloc_decompressor && l.free_decompressor &&
               l.gzip_decompress_ex;
        return l;
    }();
    return ld;
}

int hw_threads() {
    unsigned n = std::thread::hardware_concurrency();
    return n ? static_cast<int>(n) : 4;
}

template <typename F>
void parallel_ranges(int64_t n, int nthreads, F&& fn) {
    if (n <= 0) return;
    nthreads = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(nthreads, n)));
    if (nthreads == 1) {
        fn(0, n, 0);
        return;
    }
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back([&fn, lo, hi, t] { fn(lo, hi, t); });
    }
    for (auto& t : ts) t.join();
}

// Full-key comparator over packed u32 rows starting at word `w_start`
// (+ optional length column, + index for stability) — the collation the
// dedup/sort hosts share (reference comparators gzfastq_sort.c:85-103 on
// the 2-bit packing; sdscmp order for the dedup keys).
struct RowCmp {
    const uint32_t* words;
    const int32_t* lens;
    int use_len;
    int64_t W, w_start;
    bool operator()(int32_t a, int32_t c) const {
        const uint32_t* ra = words + (int64_t)a * W;
        const uint32_t* rc = words + (int64_t)c * W;
        for (int64_t w = w_start; w < W; ++w)
            if (ra[w] != rc[w]) return ra[w] < rc[w];
        if (use_len && lens[a] != lens[c]) return lens[a] < lens[c];
        return a < c;  // stability
    }
};

// Stable sort of perm[lo..hi) by words[.][w_idx..W) (+len,+idx): LSD radix
// over one u32 word packed as (key << 32 | local_rank) — byte passes at
// memory bandwidth instead of gather-heavy log-n compares — then recurse
// into equal-word runs on the next word. `key_bits` < 32 on the first word
// when the caller's MSD bucket scatter already fixed the top byte. Small
// slices fall back to std::sort (comparison wins under ~100 rows).
// Replaces a per-bucket std::sort that profiled at ~23n gather-compares
// per bucket.
static void radix_rows(const uint32_t* words, const int32_t* lens,
                       int use_len, int64_t W, int32_t* perm,
                       int64_t lo, int64_t hi, int64_t w_idx, int key_bits,
                       std::vector<uint64_t>& t0, std::vector<uint64_t>& t1,
                       std::vector<int32_t>& psnap) {
    int64_t m = hi - lo;
    if (m <= 1) return;
    if (m < 96 || w_idx >= W) {
        std::sort(perm + lo, perm + hi,
                  RowCmp{words, lens, use_len, W, std::min(w_idx, W)});
        return;
    }
    uint32_t mask = key_bits >= 32 ? 0xFFFFFFFFu
                                   : ((1u << key_bits) - 1u);
    int n_passes = (key_bits + 7) / 8;
    t0.resize(m);
    t1.resize(m);
    for (int64_t i = 0; i < m; ++i)
        t0[i] = ((uint64_t)(words[(int64_t)perm[lo + i] * W + w_idx] & mask)
                 << 32) | (uint32_t)i;
    uint64_t* src = t0.data();
    uint64_t* dst = t1.data();
    for (int p = 0; p < n_passes; ++p) {
        int shift = 32 + 8 * p;
        int64_t hist[256] = {0};
        for (int64_t i = 0; i < m; ++i) ++hist[(src[i] >> shift) & 0xFF];
        int64_t acc = 0;
        for (int d = 0; d < 256; ++d) {
            int64_t c = hist[d];
            hist[d] = acc;
            acc += c;
        }
        for (int64_t i = 0; i < m; ++i)
            dst[hist[(src[i] >> shift) & 0xFF]++] = src[i];
        std::swap(src, dst);
    }
    psnap.assign(perm + lo, perm + hi);
    for (int64_t j = 0; j < m; ++j)
        perm[lo + j] = psnap[(uint32_t)src[j]];
    // equal-key runs: same word w_idx (plus whatever the caller fixed
    // above it) — order within a run is original input order (LSD is
    // stable, rank rides the low bits), exactly what recursion expects
    int64_t run_lo = 0;
    // runs reuse the scratch vectors; snapshot run boundaries first since
    // recursion clobbers src's backing store
    std::vector<int64_t> runs;
    for (int64_t j = 1; j <= m; ++j) {
        if (j == m || (src[j] >> 32) != (src[run_lo] >> 32)) {
            if (j - run_lo > 1) {
                runs.push_back(run_lo);
                runs.push_back(j);
            }
            run_lo = j;
        }
    }
    for (size_t r = 0; r < runs.size(); r += 2)
        radix_rows(words, lens, use_len, W, perm, lo + runs[r],
                   lo + runs[r + 1], w_idx + 1, 32, t0, t1, psnap);
}

}  // namespace

extern "C" {

int ngs_version() { return 10600; }

// ---------------------------------------------------------------------------
// Newline scanning
// ---------------------------------------------------------------------------

// Count '\n' bytes in buf[0..n). Parallel memchr sweep.
int64_t ngs_count_newlines(const uint8_t* buf, int64_t n, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    std::vector<int64_t> counts(nthreads, 0);
    parallel_ranges(n, nthreads, [&](int64_t lo, int64_t hi, int t) {
        const uint8_t* p = buf + lo;
        const uint8_t* end = buf + hi;
        int64_t c = 0;
        while ((p = static_cast<const uint8_t*>(
                    memchr(p, '\n', end - p))) != nullptr) {
            ++c;
            ++p;
        }
        counts[t] = c;
    });
    int64_t total = 0;
    for (auto c : counts) total += c;
    return total;
}

// Offsets of every occurrence of byte `b` in buf[0..n), up to `cap`
// entries (returns the true total; callers re-invoke with a larger out
// when total > cap). Parallel memchr sweep — the gzip-member magic scan
// of the multi-member parallel inflate (io/fastindex.py) at memory
// bandwidth instead of numpy boolean passes.
int64_t ngs_find_byte(const uint8_t* buf, int64_t n, int b, int64_t* out,
                      int64_t cap, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    nthreads = static_cast<int>(std::max<int64_t>(
        1, std::min<int64_t>(nthreads, (n + (1 << 20) - 1) >> 20)));
    std::vector<std::vector<int64_t>> hits(nthreads);
    parallel_ranges(n, nthreads, [&](int64_t lo, int64_t hi, int t) {
        const uint8_t* p = buf + lo;
        const uint8_t* end = buf + hi;
        auto& v = hits[t];
        while ((p = static_cast<const uint8_t*>(
                    memchr(p, b, end - p))) != nullptr) {
            v.push_back(p - buf);
            ++p;
        }
    });
    int64_t total = 0, w = 0;
    for (auto& v : hits) {
        for (int64_t o : v) {
            if (w < cap) out[w++] = o;
        }
        total += static_cast<int64_t>(v.size());
    }
    return total;
}

// Write the offsets of every '\n' in buf[0..n) to out (caller-sized via
// ngs_count_newlines). Returns the count. Parallel: per-thread counts then
// per-thread fills at exclusive-prefix offsets.
int64_t ngs_find_newlines(const uint8_t* buf, int64_t n, int64_t* out,
                          int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    nthreads = static_cast<int>(std::max<int64_t>(
        1, std::min<int64_t>(nthreads, (n + (1 << 20) - 1) >> 20)));
    std::vector<int64_t> counts(nthreads + 1, 0);
    int64_t chunk = (n + nthreads - 1) / nthreads;
    parallel_ranges(n, nthreads, [&](int64_t lo, int64_t hi, int t) {
        const uint8_t* p = buf + lo;
        const uint8_t* end = buf + hi;
        int64_t c = 0;
        while ((p = static_cast<const uint8_t*>(
                    memchr(p, '\n', end - p))) != nullptr) {
            ++c;
            ++p;
        }
        counts[t + 1] = c;
    });
    for (int t = 0; t < nthreads; ++t) counts[t + 1] += counts[t];
    parallel_ranges(n, nthreads, [&](int64_t lo, int64_t hi, int t) {
        const uint8_t* p = buf + lo;
        const uint8_t* end = buf + hi;
        int64_t* o = out + counts[t];
        while ((p = static_cast<const uint8_t*>(
                    memchr(p, '\n', end - p))) != nullptr) {
            *o++ = p - buf;
            ++p;
        }
    });
    return counts[nthreads];
}

// ---------------------------------------------------------------------------
// Fused FASTQ chunk parser
//
// Replaces the find_newlines -> numpy slicing -> fill_padded x2 ->
// concat_ragged chain with exactly TWO passes over the chunk and zero
// intermediate offset arrays (the role of the reference's kseq_read loop,
// klib/kseq.h:171-211, at chunk granularity). Two-phase parallel-CSV
// structure: phase 1 counts newlines / line-length stats per thread range
// (lines that straddle a range boundary are fixed up sequentially in a
// finalize step); phase 2 copies every line straight to its destination
// (padded seq/qual row, or the compacted name blob) with one memchr sweep.
//
// State layout (int64, caller-zeroed, 4 + 14*T slots):
//   [0]=T used  [1]=n_lines  [2]=max(seq,qual len)  [3]=total name bytes
//   per-thread t at 4+14*t:
//     0:c_t newlines  1:first_nl  2:last_nl  3..6:sum of line lens by
//     (local ordinal k mod 4) for k>=1   7..10:max likewise
//     11:P_t global index of first line  12:N_t name-byte prefix
//     13:start byte offset of thread's first line
// ---------------------------------------------------------------------------

namespace {

int64_t fq_threads(int64_t n, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    // >=1MB per thread; always >=1
    return std::max<int64_t>(
        1, std::min<int64_t>(nthreads, (n + (1 << 20) - 1) >> 20));
}

}  // namespace

int ngs_hw_threads() { return hw_threads(); }

int64_t ngs_fastq_scan(const uint8_t* data, int64_t n, int64_t* state,
                       int nthreads) {
    int64_t T = fq_threads(n, nthreads);
    state[0] = T;
    int64_t chunk = (n + T - 1) / T;
    parallel_ranges(n, static_cast<int>(T), [&](int64_t lo, int64_t hi, int t) {
        int64_t* st = state + 4 + 14 * t;
        const uint8_t* p = data + lo;
        const uint8_t* end = data + hi;
        int64_t c = 0, first_nl = -1, prev = -1;
        int64_t sum4[4] = {0, 0, 0, 0};
        int64_t max4[4] = {0, 0, 0, 0};
        while ((p = static_cast<const uint8_t*>(
                    memchr(p, '\n', end - p))) != nullptr) {
            int64_t pos = p - data;
            if (c == 0) {
                first_nl = pos;
            } else {
                int64_t len = pos - prev - 1;
                int cls = static_cast<int>(c & 3);
                sum4[cls] += len;
                if (len > max4[cls]) max4[cls] = len;
            }
            prev = pos;
            ++c;
            ++p;
        }
        st[0] = c;
        st[1] = first_nl;
        st[2] = prev;  // last_nl
        for (int j = 0; j < 4; ++j) { st[3 + j] = sum4[j]; st[7 + j] = max4[j]; }
    });
    // finalize: sequential boundary fixup + prefixes
    int64_t P = 0, N = 0, maxsq = 0, prev_last = -1;
    for (int64_t t = 0; t < T; ++t) {
        int64_t* st = state + 4 + 14 * t;
        int64_t c = st[0];
        st[11] = P;
        st[12] = N;
        st[13] = prev_last + 1;
        if (c > 0) {
            // boundary line (local k=0, global index P)
            int64_t blen = st[1] - prev_last - 1;
            int bcls = static_cast<int>(P & 3);
            if (bcls == 0) N += blen;
            if ((bcls == 1 || bcls == 3) && blen > maxsq) maxsq = blen;
            // rotated accumulators: local class j holds lines with
            // global class (P + j) & 3
            int64_t j0 = (0 - P) & 3, j1 = (1 - P) & 3, j3 = (3 - P) & 3;
            N += st[3 + j0];
            if (st[7 + j1] > maxsq) maxsq = st[7 + j1];
            if (st[7 + j3] > maxsq) maxsq = st[7 + j3];
            prev_last = st[2];
            P += c;
        }
    }
    state[1] = P;
    state[2] = maxsq;
    state[3] = N;
    return P;
}

void ngs_fastq_fill(const uint8_t* data, int64_t n, const int64_t* state,
                    int64_t lmax, int need_seq, int need_qual, int need_names,
                    uint8_t* seq, uint8_t* qual, int32_t* seq_lens,
                    uint8_t* names, int64_t* name_starts, int32_t* name_lens,
                    int nthreads) {
    int64_t T = state[0];
    (void)n;
    (void)nthreads;
    parallel_ranges(T, static_cast<int>(T), [&](int64_t lo, int64_t hi, int) {
        for (int64_t t = lo; t < hi; ++t) {
            const int64_t* st = state + 4 + 14 * t;
            int64_t c = st[0];
            if (c == 0) continue;
            int64_t pos = st[13];
            int64_t g = st[11];
            int64_t name_off = st[12];
            const uint8_t* p = data + pos;
            const uint8_t* end = data + st[2] + 1;  // just past last_nl
            while (p < end) {
                const uint8_t* nlp = static_cast<const uint8_t*>(
                    memchr(p, '\n', end - p));
                int64_t len = nlp - p;
                int64_t r = g >> 2;
                switch (static_cast<int>(g & 3)) {
                    case 0:
                        if (need_names) {
                            memcpy(names + name_off, p, len);
                            name_starts[r] = name_off;
                            name_lens[r] = static_cast<int32_t>(len);
                        }
                        name_off += len;
                        break;
                    case 1: {
                        seq_lens[r] = static_cast<int32_t>(len);
                        if (need_seq) {
                            int64_t cl = len > lmax ? lmax : len;
                            uint8_t* dst = seq + r * lmax;
                            memcpy(dst, p, cl);
                            memset(dst + cl, 0, lmax - cl);
                        }
                        break;
                    }
                    case 3:
                        if (need_qual) {
                            int64_t cl = len > lmax ? lmax : len;
                            uint8_t* dst = qual + r * lmax;
                            memcpy(dst, p, cl);
                            memset(dst + cl, 0, lmax - cl);
                        }
                        break;
                    default:
                        break;  // '+' line
                }
                ++g;
                p = nlp + 1;
            }
        }
    });
}

// ---------------------------------------------------------------------------
// Padded-tensor assembly (the gather_padded hot path)
// ---------------------------------------------------------------------------

// For each row i: out[i*lmax .. ) = buf[starts[i] .. starts[i]+lens[i]),
// zero-padded to lmax. memcpy+memset per row, parallel over rows.
void ngs_fill_padded(const uint8_t* buf, const int64_t* starts,
                     const int32_t* lens, int64_t b, int64_t lmax,
                     uint8_t* out, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t len = lens[i];
            if (len > lmax) len = lmax;
            if (len < 0) len = 0;
            uint8_t* dst = out + i * lmax;
            memcpy(dst, buf + starts[i], len);
            memset(dst + len, 0, lmax - len);
        }
    });
}

// Concatenate ragged rows buf[starts[i] .. +lens[i]) at out_starts[i]
// (exclusive cumsum precomputed by the caller). Parallel over rows.
void ngs_concat_ragged(const uint8_t* buf, const int64_t* starts,
                       const int32_t* lens, const int64_t* out_starts,
                       int64_t b, uint8_t* out, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            memcpy(out + out_starts[i], buf + starts[i], lens[i]);
        }
    });
}

// Inverse: scatter padded rows back into a ragged buffer with per-row
// trailing extras (used by the FASTQ writer).
void ngs_scatter_rows(const uint8_t* padded, const int32_t* lens,
                      int64_t b, int64_t lmax, const int64_t* out_starts,
                      uint8_t* out, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            memcpy(out + out_starts[i], padded + i * lmax, lens[i]);
        }
    });
}

// Row-wise ragged concatenation of two padded matrices:
// out[i] = a[i][:la[i]] ++ b[i][:lb[i]], zero-padded to lmax_out.
// (The PE dedup key of gzfastq_uniq.c:212-213 is seq1++seq2 at true lengths.)
void ngs_concat_pairs(const uint8_t* a, const int32_t* la, int64_t lmax_a,
                      const uint8_t* b, const int32_t* lb, int64_t lmax_b,
                      int64_t n, int64_t lmax_out, uint8_t* out,
                      int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    parallel_ranges(n, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            uint8_t* dst = out + i * lmax_out;
            int64_t l1 = la[i], l2 = lb[i];
            memcpy(dst, a + i * lmax_a, l1);
            memcpy(dst + l1, b + i * lmax_b, l2);
            memset(dst + l1 + l2, 0, lmax_out - l1 - l2);
        }
    });
}

// ---------------------------------------------------------------------------
// FASTQ record assembly (writer): name[+suffix]\nseq\n+\nqual\n per record.
// starts/lens address the ragged name blob; seq/qual are padded matrices.
// out_starts = precomputed record offsets. Parallel over records.
// ---------------------------------------------------------------------------
void ngs_format_fastq(const uint8_t* names, const int64_t* name_starts,
                      const int32_t* name_lens, const uint8_t* suffixes,
                      const int64_t* suffix_starts, const int32_t* suffix_lens,
                      const uint8_t* seq, const uint8_t* qual,
                      const int32_t* lens, const int32_t* qual_lens,
                      int64_t b, int64_t lmax, const int64_t* out_starts,
                      uint8_t* out, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            uint8_t* o = out + out_starts[i];
            int32_t nl = name_lens[i];
            memcpy(o, names + name_starts[i], nl);
            o += nl;
            if (suffixes) {
                memcpy(o, suffixes + suffix_starts[i], suffix_lens[i]);
                o += suffix_lens[i];
            }
            *o++ = '\n';
            int32_t sl = lens[i];
            memcpy(o, seq + i * lmax, sl);
            o += sl;
            *o++ = '\n';
            *o++ = '+';
            *o++ = '\n';
            int32_t ql = qual_lens ? qual_lens[i] : sl;
            memcpy(o, qual + i * lmax, ql);
            o += ql;
            *o++ = '\n';
        }
    });
}

// ---------------------------------------------------------------------------
// Gather+format FASTQ subset in one pass (the dedup emit hot path):
// record k = name[idx_n[k]] ["\t" count[k]] "\n" seq[idx_s[k]][:slen] "\n+\n"
// qual[idx_q[k]][:qlen] "\n". Caller precomputes out_starts (record offsets,
// exclusive cumsum); counts may be null. Parallel over records — replaces a
// numpy gather chain + per-record Python "%d" formatting.
// ---------------------------------------------------------------------------
static inline uint8_t* put_i64(uint8_t* o, int64_t v);

void ngs_format_fastq_take(
    const uint8_t* names, const int64_t* name_starts, const int32_t* name_lens,
    const int64_t* idx_n, const int64_t* counts,
    const uint8_t* seq, int64_t lmax_s, const int32_t* slens,
    const int64_t* idx_s,
    const uint8_t* qual, int64_t lmax_q, const int32_t* qlens,
    const int64_t* idx_q,
    int64_t k_total, const int64_t* out_starts, uint8_t* out, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    parallel_ranges(k_total, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t k = lo; k < hi; ++k) {
            uint8_t* o = out + out_starts[k];
            int64_t in = idx_n[k];
            int32_t nl = name_lens[in];
            memcpy(o, names + name_starts[in], nl);
            o += nl;
            if (counts) {
                *o++ = '\t';
                o = put_i64(o, counts[k]);
            }
            *o++ = '\n';
            int64_t is = idx_s[k];
            int32_t sl = slens[is];
            memcpy(o, seq + is * lmax_s, sl);
            o += sl;
            *o++ = '\n';
            *o++ = '+';
            *o++ = '\n';
            int64_t iq = idx_q[k];
            int32_t ql = qlens[iq];
            memcpy(o, qual + iq * lmax_q, ql);
            o += ql;
            *o++ = '\n';
        }
    });
}

// ---------------------------------------------------------------------------
// Parallel gzip (multi-stream) compression: compress n_blocks independent
// gzip members concurrently; concatenated members form a valid gzip file.
// Caller provides per-block bounds; returns per-block compressed sizes.
// ---------------------------------------------------------------------------
int ngs_gzip_compress_blocks(const uint8_t* data, const int64_t* block_starts,
                             const int64_t* block_lens, int64_t n_blocks,
                             uint8_t* out, const int64_t* out_caps,
                             const int64_t* out_offsets, int64_t* out_sizes,
                             int level, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    std::atomic<int> err{0};
    const LibDeflate& ld = libdeflate();
    const bool fast = ld.alloc_compressor && ld.free_compressor &&
                      ld.gzip_compress;
    parallel_ranges(n_blocks, nthreads, [&](int64_t lo, int64_t hi, int) {
        void* comp = fast ? ld.alloc_compressor(level) : nullptr;
        for (int64_t i = lo; i < hi; ++i) {
            if (comp) {
                size_t got = ld.gzip_compress(
                    comp, data + block_starts[i],
                    static_cast<size_t>(block_lens[i]), out + out_offsets[i],
                    static_cast<size_t>(out_caps[i]));
                if (got > 0) {  // 0 == output did not fit: zlib fallback
                    out_sizes[i] = static_cast<int64_t>(got);
                    continue;
                }
            }
            z_stream zs;
            memset(&zs, 0, sizeof(zs));
            if (deflateInit2(&zs, level, Z_DEFLATED, 16 + 15, 8,
                             Z_DEFAULT_STRATEGY) != Z_OK) {
                err.store(1);
                break;
            }
            zs.next_in = const_cast<uint8_t*>(data + block_starts[i]);
            zs.avail_in = static_cast<uInt>(block_lens[i]);
            zs.next_out = out + out_offsets[i];
            zs.avail_out = static_cast<uInt>(out_caps[i]);
            int r = deflate(&zs, Z_FINISH);
            if (r != Z_STREAM_END) err.store(2);
            out_sizes[i] = static_cast<int64_t>(zs.total_out);
            deflateEnd(&zs);
        }
        if (comp) ld.free_compressor(comp);
    });
    return err.load();
}

// Parallel gzip decompression of independent members (BGZF-style usage):
// each block [start, start+len) must be a complete gzip member sequence.
int ngs_gzip_decompress_blocks(const uint8_t* data, const int64_t* block_starts,
                               const int64_t* block_lens, int64_t n_blocks,
                               uint8_t* out, const int64_t* out_offsets,
                               const int64_t* out_caps, int64_t* out_sizes,
                               int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    std::atomic<int> err{0};
    const LibDeflate& ld = libdeflate();
    parallel_ranges(n_blocks, nthreads, [&](int64_t lo, int64_t hi, int) {
        void* dec = ld.ok ? ld.alloc_decompressor() : nullptr;
        for (int64_t i = lo; i < hi; ++i) {
            if (dec) {
                // fast path: walk the (possibly concatenated) gzip members
                // of this block with libdeflate; any hiccup falls through
                // to the zlib loop below for this block only.
                const uint8_t* in = data + block_starts[i];
                size_t in_left = static_cast<size_t>(block_lens[i]);
                int64_t produced = 0;
                bool good = true;
                while (in_left > 0) {
                    size_t used = 0, got = 0;
                    int r = ld.gzip_decompress_ex(
                        dec, in, in_left, out + out_offsets[i] + produced,
                        static_cast<size_t>(out_caps[i] - produced), &used,
                        &got);
                    if (r != 0 || used == 0) { good = false; break; }
                    produced += static_cast<int64_t>(got);
                    in += used;
                    in_left -= used;
                }
                if (good) {
                    out_sizes[i] = produced;
                    continue;
                }
            }
            z_stream zs;
            memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, 16 + 15) != Z_OK) {
                err.store(1);
                if (dec) ld.free_decompressor(dec);
                return;
            }
            zs.next_in = const_cast<uint8_t*>(data + block_starts[i]);
            zs.avail_in = static_cast<uInt>(block_lens[i]);
            int64_t produced = 0;
            int r = Z_OK;
            while (true) {
                zs.next_out = out + out_offsets[i] + produced;
                zs.avail_out = static_cast<uInt>(out_caps[i] - produced);
                r = inflate(&zs, Z_NO_FLUSH);
                produced = static_cast<int64_t>(zs.total_out);
                if (r == Z_STREAM_END) {
                    if (zs.avail_in == 0) break;
                    // concatenated member: reset and continue
                    if (inflateReset2(&zs, 16 + 15) != Z_OK) { r = Z_DATA_ERROR; break; }
                } else if (r != Z_OK) {
                    break;
                } else if (zs.avail_out == 0 && produced >= out_caps[i]) {
                    r = Z_BUF_ERROR;
                    break;
                }
            }
            if (r != Z_STREAM_END) err.store(2);
            out_sizes[i] = produced;
            inflateEnd(&zs);
        }
        if (dec) ld.free_decompressor(dec);
    });
    return err.load();
}

// BGZF-specialized parallel inflate: every block [start, start+len) is ONE
// gzip member whose framing the caller already scanned host-side (BGZF
// BSIZE headers + ISIZE trailers, io/bgzf.py _scan_blocks_ex). Decode goes
// straight to the raw DEFLATE payload — skipping libdeflate's gzip-wrapper
// walk and, unless verify_crc != 0, the mandatory whole-output CRC32 of
// the gzip entry point (a few % of the dominant decode stage; the produced
// size is still checked against ISIZE by the caller via out_sizes). The
// reference pays both through zlib's gzread (reference klib/bgzf.c).
// Any header-parse or decode hiccup falls back to zlib raw inflate for
// that block; a block that still fails sets the error flag.
int ngs_bgzf_inflate_blocks(const uint8_t* data, const int64_t* block_starts,
                            const int64_t* block_lens, int64_t n_blocks,
                            uint8_t* out, const int64_t* out_offsets,
                            const int64_t* out_caps, int64_t* out_sizes,
                            int verify_crc, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    std::atomic<int> err{0};
    const LibDeflate& ld = libdeflate();
    const bool raw_ok = ld.ok && ld.deflate_decompress_ex &&
                        (!verify_crc || ld.crc32);
    parallel_ranges(n_blocks, nthreads, [&](int64_t lo, int64_t hi, int) {
        void* dec = raw_ok ? ld.alloc_decompressor() : nullptr;
        z_stream zs;
        bool zs_live = false;
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* m = data + block_starts[i];
            const int64_t mlen = block_lens[i];
            // gzip member header walk (RFC 1952): fixed 10 bytes, then
            // FEXTRA/FNAME/FCOMMENT/FHCRC as flagged. BGZF members are
            // always magic+FLG=4+XLEN, but stay general for safety.
            int64_t o = 10;
            bool parsed = mlen >= 18 && m[0] == 0x1F && m[1] == 0x8B &&
                          m[2] == 8;
            uint8_t flg = parsed ? m[3] : 0;
            if (parsed && (flg & 4)) {  // FEXTRA
                if (o + 2 <= mlen) {
                    uint16_t xlen;
                    memcpy(&xlen, m + o, 2);
                    o += 2 + xlen;
                } else {
                    parsed = false;
                }
            }
            if (parsed && (flg & 8)) {  // FNAME
                while (o < mlen && m[o]) ++o;
                ++o;
            }
            if (parsed && (flg & 16)) {  // FCOMMENT
                while (o < mlen && m[o]) ++o;
                ++o;
            }
            if (parsed && (flg & 2)) o += 2;  // FHCRC
            if (o + 8 > mlen) parsed = false;
            int64_t got = -1;
            if (parsed) {
                const uint8_t* payload = m + o;
                const size_t plen = static_cast<size_t>(mlen - o - 8);
                if (dec) {
                    size_t used = 0, produced = 0;
                    int r = ld.deflate_decompress_ex(
                        dec, payload, plen, out + out_offsets[i],
                        static_cast<size_t>(out_caps[i]), &used, &produced);
                    if (r == 0) got = static_cast<int64_t>(produced);
                }
                if (got < 0) {  // zlib raw-inflate fallback for this block
                    if (!zs_live) {
                        memset(&zs, 0, sizeof(zs));
                        if (inflateInit2(&zs, -15) != Z_OK) {
                            err.store(1);
                            break;
                        }
                        zs_live = true;
                    } else {
                        inflateReset2(&zs, -15);
                    }
                    zs.next_in = const_cast<uint8_t*>(payload);
                    zs.avail_in = static_cast<uInt>(plen);
                    zs.next_out = out + out_offsets[i];
                    zs.avail_out = static_cast<uInt>(out_caps[i]);
                    int r = inflate(&zs, Z_FINISH);
                    if (r == Z_STREAM_END)
                        got = static_cast<int64_t>(zs.total_out);
                }
                if (got >= 0 && verify_crc) {
                    uint32_t want;
                    memcpy(&want, m + mlen - 8, 4);
                    uint32_t have =
                        ld.crc32 ? ld.crc32(0, out + out_offsets[i],
                                            static_cast<size_t>(got))
                                 : static_cast<uint32_t>(::crc32(
                                       0, out + out_offsets[i],
                                       static_cast<uInt>(got)));
                    if (have != want) got = -1;
                }
            }
            if (got < 0) {
                err.store(2);
                out_sizes[i] = 0;
                continue;
            }
            out_sizes[i] = got;
        }
        if (zs_live) inflateEnd(&zs);
        if (dec) ld.free_decompressor(dec);
    });
    return err.load();
}

// ---------------------------------------------------------------------------
// mrle quality RLE codec (bit-exact port of gzfastq_mrle.c:47-115)
// Batch API: encode each row of a padded quality matrix; outputs are
// length-prefixed (1 byte, truncated like the reference's fwrite of an int
// as unsigned char) streams concatenated into `out`.
// ---------------------------------------------------------------------------

static const uint8_t MRLE_TABLE_INIT[6] = {'#', '/', '7', '<', 'B', 'F'};

// Encode one quality string with the reference's two-pass per-symbol RLE
// (bit-parity with gzfastq_mrle.c mrlec2, cited, not copied): a census
// pass scores, for each of the 6 alphabet symbols, whether run-coding it
// shrinks the output; the emit pass then writes a bitmask of the coded
// symbols followed by each maximal run either as sym + 255-saturated
// continuation counts (coded symbols) or verbatim (uncoded). Both passes
// here walk MAXIMAL RUNS — a run of length L contributes
// (L-1) - floor((L-1)/255) continuation credits minus 1 head debit to
// its symbol's score, and emits as sym, 255..., (L mod 255 payload) with
// the final count byte holding remaining-1.
static int mrle_encode_one(const uint8_t* q, int n, uint8_t* out,
                           const uint8_t* table) {
    long long score[8] = {0};
    for (int i = 0; i < n;) {
        int j = i + 1;
        while (j < n && q[j] == q[i]) ++j;
        long long cont = j - i - 1;  // continuation chars in this run
        score[table[q[i]]] += cont - cont / 255 - 1;
        i = j;
    }
    uint8_t* w = out;
    int coded_mask = 0;
    for (int s = 0; s < 8; ++s) coded_mask |= (score[s] > 0) << s;
    *w++ = (uint8_t)coded_mask;
    for (int i = 0; i < n;) {
        int j = i + 1;
        while (j < n && q[j] == q[i]) ++j;
        uint8_t sym = q[i];
        long long len = j - i;
        if (score[table[sym]] > 0) {
            *w++ = sym;
            for (; len > 255; len -= 255) *w++ = 255;
            *w++ = (uint8_t)(len - 1);
        } else {
            for (; len > 0; --len) *w++ = sym;
        }
        i = j;
    }
    return (int)(w - out);
}

// rows: padded [b, lmax] with per-row lens; out sized >= sum(2*len+2).
// out_lens[i] receives each encoded length (pre-truncation); the stream in
// `out` is lenbyte+payload per record. Returns total bytes, or -1 if a
// quality byte falls outside the 6-symbol alphabet (reference UB).
int64_t ngs_mrle_encode_rows(const uint8_t* rows, const int32_t* lens,
                             int64_t b, int64_t lmax, uint8_t* out,
                             int32_t* out_lens) {
    uint8_t table[256];
    memset(table, 255, sizeof(table));
    for (int i = 0; i < 6; ++i) table[MRLE_TABLE_INIT[i]] = (uint8_t)i;
    uint8_t* op = out;
    for (int64_t i = 0; i < b; ++i) {
        const uint8_t* q = rows + i * lmax;
        int n = lens[i];
        for (int k = 0; k < n; ++k) {
            if (table[q[k]] == 255) return -1;
        }
        uint8_t* lenbyte = op++;
        int enc = mrle_encode_one(q, n, op, table);
        *lenbyte = (uint8_t)(enc & 0xFF);
        op += enc;
        out_lens[i] = enc;
    }
    return op - out;
}

// ---------------------------------------------------------------------------
// Offset-indexed FASTQ fast path (zero-materialization pipeline)
//
// Instead of copying every record into padded matrices, these functions
// index the raw (mmap'd or inflated) buffer once and then run every
// downstream stage — QC histogram, quality sums, 2-bit sort-key packing,
// trim/uniq text assembly — as offset-based gathers straight out of the
// original bytes. On hosts with slow first-touch page faults this removes
// ~550MB of materialized intermediates per 450MB input. Plays the role of
// the reference's 4x-gzgets readers + per-tool re-reads (e.g. reference
// fastq_trim.c:67-89, gzfastq_uniq.c:170-192) collapsed into one pass.
// ---------------------------------------------------------------------------

// Fill per-record line offsets/lengths from the scan state produced by
// ngs_fastq_scan (same two-phase thread decomposition as ngs_fastq_fill).
void ngs_fastq_index(const uint8_t* data, int64_t n, const int64_t* state,
                     int64_t* name_off, int32_t* name_len,
                     int64_t* seq_off, int32_t* seq_len,
                     int64_t* qual_off, int32_t* qual_len, int nthreads) {
    int64_t T = state[0];
    (void)n;
    (void)nthreads;
    parallel_ranges(T, static_cast<int>(T), [&](int64_t lo, int64_t hi, int) {
        for (int64_t t = lo; t < hi; ++t) {
            const int64_t* st = state + 4 + 14 * t;
            int64_t c = st[0];
            if (c == 0) continue;
            int64_t pos = st[13];
            int64_t g = st[11];
            const uint8_t* p = data + pos;
            const uint8_t* end = data + st[2] + 1;
            while (p < end) {
                const uint8_t* nlp = static_cast<const uint8_t*>(
                    memchr(p, '\n', end - p));
                int64_t off = p - data;
                int32_t len = static_cast<int32_t>(nlp - p);
                int64_t r = g >> 2;
                switch (static_cast<int>(g & 3)) {
                    case 0: name_off[r] = off; name_len[r] = len; break;
                    case 1: seq_off[r] = off; seq_len[r] = len; break;
                    case 3: qual_off[r] = off; qual_len[r] = len; break;
                    default: break;
                }
                ++g;
                p = nlp + 1;
            }
        }
    });
}

namespace {

struct DnaTables {
    uint8_t rank[256];
    uint8_t bad[256];
    DnaTables() {
        memset(rank, 0, sizeof(rank));
        memset(bad, 1, sizeof(bad));
        rank[(uint8_t)'A'] = 0; bad[(uint8_t)'A'] = 0;
        rank[(uint8_t)'C'] = 1; bad[(uint8_t)'C'] = 0;
        rank[(uint8_t)'G'] = 2; bad[(uint8_t)'G'] = 0;
        rank[(uint8_t)'T'] = 3; bad[(uint8_t)'T'] = 0;
    }
};

// per-record fused work shared by ngs_fastq_fused / ngs_fastq_index_fused:
// quality histogram + sum, length histogram, speculative 2-bit pack,
// leading-byte bucket histogram
inline void fused_record(const DnaTables& tb, const uint8_t* data,
                         int64_t soff, int64_t sl, int64_t qoff, int64_t ql,
                         int64_t words, uint32_t* o, uint32_t* sumq_i,
                         uint64_t* hq, uint64_t* hl, uint32_t* hb,
                         int* badrow, int64_t n_qual, int64_t n_len) {
    const uint8_t* q = data + qoff;
    int64_t lim = ql < n_len ? ql : n_len;
    uint32_t s = 0;
    if (hq) {
        for (int64_t k = 0; k < lim; ++k) {
            uint8_t c = q[k];
            s += c;
            if (c < n_qual) ++hq[k * n_qual + c];
        }
        for (int64_t k = lim; k < ql; ++k) s += q[k];
    } else {
        // hist-free callers (dedup-only paths): plain byte sum, which the
        // compiler vectorizes — the per-cycle histogram is the single
        // hottest increment stream of the fused pass (reads x read_len)
        for (int64_t k = 0; k < ql; ++k) s += q[k];
    }
    *sumq_i = s;
    int64_t lbin = sl < 0 ? 0 : (sl >= n_len ? n_len - 1 : sl);
    ++hl[lbin];
    const uint8_t* sp = data + soff;
    int64_t full = sl / 16 < words ? sl / 16 : words;
    const uint8_t* p = sp;
    for (int64_t w = 0; w < full; ++w, p += 16) {
        uint32_t acc = 0;
        for (int k = 0; k < 16; ++k) {
            acc = (acc << 2) | tb.rank[p[k]];
            *badrow |= tb.bad[p[k]];
        }
        o[w] = acc;
    }
    int64_t pos = full * 16;
    for (int64_t w = full; w < words; ++w) {
        uint32_t acc = 0;
        for (int k = 0; k < 16; ++k, ++pos) {
            uint32_t r = 0;
            if (pos < sl) {
                r = tb.rank[sp[pos]];
                *badrow |= tb.bad[sp[pos]];
            }
            acc = (acc << 2) | r;
        }
        o[w] = acc;
    }
    ++hb[words ? (o[0] >> 24) : 0];
}

}  // namespace

// Index + fused pass in ONE sweep over the bytes: record offsets/lengths
// AND the QC histograms / quality sums / 2-bit sort keys / bucket
// histogram come out of a single record-aligned walk per thread — the
// bytes are still in cache when the fused work runs, removing the full
// re-read ngs_fastq_index + ngs_fastq_fused pay as separate passes.
// Thread decomposition: from the ngs_fastq_scan state, thread t owns
// records [ceil(P_t/4), ceil(P_{t+1}/4)) and finds its record-aligned
// byte start by advancing <= 3 newlines from its first-line offset (a
// walk may read past its range end into the next thread's bytes; record
// ownership stays exclusive). Returns 0 when all sequence bytes were
// ACGT, 1 otherwise.
int ngs_fastq_index_fused(const uint8_t* data, int64_t n,
                          const int64_t* state,
                          int64_t* name_off, int32_t* name_len,
                          int64_t* seq_off, int32_t* seq_len,
                          int64_t* qual_off, int32_t* qual_len,
                          int64_t words, uint32_t* words_out, uint32_t* sumq,
                          uint64_t* hist_q, uint64_t* hist_len,
                          int64_t n_qual, int64_t n_len,
                          uint32_t* bucket_hist, int nthreads) {
    static const DnaTables tb;
    int64_t T = state[0];
    int64_t total_lines = state[1];
    int64_t total_rec = total_lines / 4;
    (void)nthreads;
    // record-aligned start per thread: (first record index, byte offset)
    std::vector<int64_t> r0(T + 1, total_rec), b0(T, -1);
    for (int64_t t = 0; t < T; ++t) {
        const int64_t* st = state + 4 + 14 * t;
        if (st[0] == 0) continue;  // no lines in this thread's range
        int64_t p_t = st[11];
        int64_t rec = (p_t + 3) / 4;
        int64_t skip = rec * 4 - p_t;
        const uint8_t* p = data + st[13];
        const uint8_t* end = data + n;
        while (skip > 0 && p < end) {
            p = static_cast<const uint8_t*>(memchr(p, '\n', end - p));
            if (p == nullptr) { p = end; break; }
            ++p;
            --skip;
        }
        r0[t] = rec;
        b0[t] = p - data;
    }
    // propagate: a thread with no start inherits the next thread's
    for (int64_t t = T - 1; t >= 0; --t) {
        if (b0[t] < 0) {
            r0[t] = r0[t + 1];
        }
    }
    // hist_q == NULL skips the per-cycle quality histogram entirely
    // (dedup-only callers; the length histogram stays, it is trivial)
    std::vector<std::vector<uint64_t>> part_q(
        hist_q ? T : 0, std::vector<uint64_t>(n_len * n_qual, 0));
    std::vector<std::vector<uint64_t>> part_l(
        T, std::vector<uint64_t>(n_len, 0));
    std::vector<std::array<uint32_t, 256>> part_b(T);
    for (auto& a : part_b) a.fill(0);
    std::atomic<int> any_bad{0};
    parallel_ranges(T, static_cast<int>(T), [&](int64_t lo_t, int64_t hi_t,
                                                int) {
        for (int64_t t = lo_t; t < hi_t; ++t) {
            int64_t r = r0[t], r_end = r0[t + 1];
            if (r >= r_end) continue;
            uint64_t* hq = hist_q ? part_q[t].data() : nullptr;
            uint64_t* hl = part_l[t].data();
            uint32_t* hb = part_b[t].data();
            int badrow = 0;
            const uint8_t* p = data + b0[t];
            const uint8_t* end = data + n;
            for (; r < r_end; ++r) {
                int64_t offs[4];
                int32_t lens4[4];
                for (int k = 0; k < 4; ++k) {
                    const uint8_t* nlp = static_cast<const uint8_t*>(
                        memchr(p, '\n', end - p));
                    offs[k] = p - data;
                    lens4[k] = static_cast<int32_t>(nlp - p);
                    p = nlp + 1;
                }
                name_off[r] = offs[0];
                name_len[r] = lens4[0];
                seq_off[r] = offs[1];
                seq_len[r] = lens4[1];
                qual_off[r] = offs[3];
                qual_len[r] = lens4[3];
                fused_record(tb, data, offs[1], lens4[1], offs[3], lens4[3],
                             words, words_out + r * words, sumq + r,
                             hq, hl, hb, &badrow, n_qual, n_len);
            }
            if (badrow) any_bad.store(1, std::memory_order_relaxed);
        }
    });
    for (int64_t t = 0; t < T; ++t) {
        if (hist_q)
            for (int64_t j = 0; j < n_len * n_qual; ++j)
                hist_q[j] += part_q[t][j];
        for (int64_t j = 0; j < n_len; ++j) hist_len[j] += part_l[t][j];
        for (int j = 0; j < 256; ++j) bucket_hist[j] += part_b[t][j];
    }
    return any_bad.load();
}

// One fused pass over the indexed records: QC quality histogram (cycle-major
// [n_len, n_qual] u64, ACCUMULATED) + length histogram, per-record quality
// sums, speculative 2-bit ACGT sort-key packing (W words per row, padding
// rank 0), and a 256-bucket histogram of each row's leading packed byte
// (word0 >> 24) used to choose balanced device-sort partitions. Returns 0
// if every sequence byte was in {A,C,G,T}; 1 otherwise (caller falls back
// to the generic alphabet path — words_out contents are then unspecified).
int ngs_fastq_fused(const uint8_t* data,
                    const int64_t* seq_off, const int32_t* seq_len,
                    const int64_t* qual_off, const int32_t* qual_len,
                    int64_t b, int64_t words,
                    uint32_t* words_out, uint32_t* sumq,
                    uint64_t* hist_q, uint64_t* hist_len,
                    int64_t n_qual, int64_t n_len,
                    uint32_t* bucket_hist, int nthreads) {
    static uint8_t rank[256];
    static uint8_t bad[256];
    static bool init = false;
    if (!init) {
        memset(rank, 0, sizeof(rank));
        memset(bad, 1, sizeof(bad));
        rank[(uint8_t)'A'] = 0; bad[(uint8_t)'A'] = 0;
        rank[(uint8_t)'C'] = 1; bad[(uint8_t)'C'] = 0;
        rank[(uint8_t)'G'] = 2; bad[(uint8_t)'G'] = 0;
        rank[(uint8_t)'T'] = 3; bad[(uint8_t)'T'] = 0;
        init = true;
    }
    if (nthreads <= 0) nthreads = hw_threads();
    nthreads = static_cast<int>(std::max<int64_t>(
        1, std::min<int64_t>(nthreads, (b + 4095) / 4096)));
    std::vector<std::vector<uint64_t>> part_q(
        nthreads, std::vector<uint64_t>(n_len * n_qual, 0));
    std::vector<std::vector<uint64_t>> part_l(
        nthreads, std::vector<uint64_t>(n_len, 0));
    std::vector<std::array<uint32_t, 256>> part_b(nthreads);
    for (auto& a : part_b) a.fill(0);
    std::atomic<int> any_bad{0};
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int t) {
        uint64_t* hq = part_q[t].data();
        uint64_t* hl = part_l[t].data();
        uint32_t* hb = part_b[t].data();
        int badrow = 0;
        for (int64_t i = lo; i < hi; ++i) {
            // quality: histogram + sum in one sweep
            const uint8_t* q = data + qual_off[i];
            int64_t ql = qual_len[i];
            int64_t lim = std::min<int64_t>(ql, n_len);
            uint32_t s = 0;
            for (int64_t k = 0; k < lim; ++k) {
                uint8_t c = q[k];
                s += c;
                if (c < n_qual) ++hq[k * n_qual + c];
            }
            for (int64_t k = lim; k < ql; ++k) s += q[k];
            sumq[i] = s;
            int64_t sl = seq_len[i];
            int64_t lbin = sl < 0 ? 0 : (sl >= n_len ? n_len - 1 : sl);
            ++hl[lbin];
            // sequence: speculative 2-bit pack
            const uint8_t* sp = data + seq_off[i];
            uint32_t* o = words_out + i * words;
            int64_t full = std::min(sl / 16, words);
            const uint8_t* p = sp;
            for (int64_t w = 0; w < full; ++w, p += 16) {
                uint32_t acc = 0;
                for (int k = 0; k < 16; ++k) {
                    acc = (acc << 2) | rank[p[k]];
                    badrow |= bad[p[k]];
                }
                o[w] = acc;
            }
            int64_t pos = full * 16;
            for (int64_t w = full; w < words; ++w) {
                uint32_t acc = 0;
                for (int k = 0; k < 16; ++k, ++pos) {
                    uint32_t r = 0;
                    if (pos < sl) { r = rank[sp[pos]]; badrow |= bad[sp[pos]]; }
                    acc = (acc << 2) | r;
                }
                o[w] = acc;
            }
            ++hb[words ? (o[0] >> 24) : 0];
        }
        if (badrow) any_bad.store(1, std::memory_order_relaxed);
    });
    for (int t = 0; t < nthreads; ++t) {
        for (int64_t j = 0; j < n_len * n_qual; ++j) hist_q[j] += part_q[t][j];
        for (int64_t j = 0; j < n_len; ++j) hist_len[j] += part_l[t][j];
        for (int j = 0; j < 256; ++j) bucket_hist[j] += part_b[t][j];
    }
    return any_bad.load();
}

// Paired-end fused pass: pack seq1||seq2 of each pair into one continuous
// 2-bit stream (the sds key sdscatlen of reference gzfastq_uniq.c:212-213
// as a bit-packed sort key), sum both mates' quality bytes, and histogram
// the leading packed byte for device partitioning. No QC histograms — the
// standalone PE dedup does not need them. Returns 0 when every sequence
// byte (both mates) was in {A,C,G,T}; 1 otherwise.
int ngs_fastq_fused_pair(const uint8_t* d1,
                         const int64_t* seq_off1, const int32_t* seq_len1,
                         const int64_t* qual_off1, const int32_t* qual_len1,
                         const uint8_t* d2,
                         const int64_t* seq_off2, const int32_t* seq_len2,
                         const int64_t* qual_off2, const int32_t* qual_len2,
                         int64_t b, int64_t words,
                         uint32_t* words_out, uint32_t* sumq,
                         uint32_t* bucket_hist, int nthreads) {
    static uint8_t rank[256];
    static uint8_t bad[256];
    static bool init = false;
    if (!init) {
        memset(rank, 0, sizeof(rank));
        memset(bad, 1, sizeof(bad));
        rank[(uint8_t)'A'] = 0; bad[(uint8_t)'A'] = 0;
        rank[(uint8_t)'C'] = 1; bad[(uint8_t)'C'] = 0;
        rank[(uint8_t)'G'] = 2; bad[(uint8_t)'G'] = 0;
        rank[(uint8_t)'T'] = 3; bad[(uint8_t)'T'] = 0;
        init = true;
    }
    if (nthreads <= 0) nthreads = hw_threads();
    std::vector<std::array<uint32_t, 256>> part_b(nthreads);
    for (auto& a : part_b) a.fill(0);
    std::atomic<int> any_bad{0};
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int t) {
        uint32_t* hb = part_b[t].data();
        int badrow = 0;
        for (int64_t i = lo; i < hi; ++i) {
            uint32_t* o = words_out + i * words;
            uint32_t acc = 0;
            int nb = 0;
            int64_t w = 0;
            auto push = [&](const uint8_t* p, int64_t n) {
                for (int64_t k = 0; k < n; ++k) {
                    acc = (acc << 2) | rank[p[k]];
                    badrow |= bad[p[k]];
                    if (++nb == 16) {
                        if (w < words) o[w] = acc;
                        ++w;
                        acc = 0;
                        nb = 0;
                    }
                }
            };
            push(d1 + seq_off1[i], seq_len1[i]);
            push(d2 + seq_off2[i], seq_len2[i]);
            if (nb) {
                acc <<= 2 * (16 - nb);
                if (w < words) o[w] = acc;
                ++w;
            }
            for (; w < words; ++w) o[w] = 0;
            uint32_t s = 0;
            const uint8_t* q1 = d1 + qual_off1[i];
            for (int64_t k = 0; k < qual_len1[i]; ++k) s += q1[k];
            const uint8_t* q2 = d2 + qual_off2[i];
            for (int64_t k = 0; k < qual_len2[i]; ++k) s += q2[k];
            sumq[i] = s;
            ++hb[words ? (o[0] >> 24) : 0];
        }
        if (badrow) any_bad.store(1, std::memory_order_relaxed);
    });
    for (int t = 0; t < nthreads; ++t)
        for (int j = 0; j < 256; ++j) bucket_hist[j] += part_b[t][j];
    return any_bad.load();
}

// Trim text assembly straight from the raw buffer:
// record i = name\n seq[s:s+cl)\n +\n qual[s:s+cl)\n with
// cl = clamp(min(seq_len, e) - s, 0, ...). Bytes the quality line does not
// cover are written as NUL — identical to the padded-matrix writer the
// generic path uses (reference fastq_trim.c:67-89 strncpy slices).
void ngs_trim_format_ofs(const uint8_t* data,
                         const int64_t* name_off, const int32_t* name_len,
                         const int64_t* seq_off, const int32_t* seq_len,
                         const int64_t* qual_off, const int32_t* qual_len,
                         int64_t b, int32_t s, int32_t e,
                         const int64_t* out_starts, uint8_t* out,
                         int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            uint8_t* o = out + out_starts[i];
            int32_t nl = name_len[i];
            memcpy(o, data + name_off[i], nl);
            o += nl;
            *o++ = '\n';
            int64_t sl = seq_len[i];
            int64_t cl = std::min<int64_t>(sl, e) - s;
            if (cl < 0) cl = 0;
            memcpy(o, data + seq_off[i] + s, cl);
            o += cl;
            *o++ = '\n';
            *o++ = '+';
            *o++ = '\n';
            int64_t qavail = std::max<int64_t>(
                0, std::min<int64_t>(qual_len[i], e) - s);
            int64_t qreal = std::min(cl, qavail);
            memcpy(o, data + qual_off[i] + s, qreal);
            if (qreal < cl) memset(o + qreal, 0, cl - qreal);
            o += cl;
            *o++ = '\n';
        }
    });
}

// Dedup emit straight from the raw buffer: record k (rep index r=rep[k]) =
// name[r]\t{count[k]}\n seq[r]\n +\n qual[r] (seq_len bytes, NUL-filled past
// qual_len)\n — the gzfastq_uniq output record (reference
// gzfastq_uniq.c:325-357) as an offset gather.
// sep: the byte between name and the numeric suffix when counts != NULL
// ('\t' for the dedup "name\tcount" records of gzfastq_uniq.c:325-357,
// '_' for gzfastq_sample's "name_ordinal" renames, gzfastq_sample.c:30-37).
void ngs_format_uniq_ofs(const uint8_t* data,
                         const int64_t* name_off, const int32_t* name_len,
                         const int64_t* seq_off, const int32_t* seq_len,
                         const int64_t* qual_off, const int32_t* qual_len,
                         const int64_t* rep, const int64_t* counts,
                         int64_t k_total, const int64_t* out_starts,
                         uint8_t* out, int sep, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    parallel_ranges(k_total, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t k = lo; k < hi; ++k) {
            if (k + 8 < hi) {
                // reps land in key-sorted (i.e. random) order across the
                // whole input: the three source gathers are TLB+cache
                // misses — prefetch a few records ahead hides most of it
                int64_t rp = rep[k + 8];
                __builtin_prefetch(data + name_off[rp]);
                __builtin_prefetch(data + seq_off[rp]);
                __builtin_prefetch(data + qual_off[rp]);
            }
            int64_t r = rep[k];
            uint8_t* o = out + out_starts[k];
            int32_t nl = name_len[r];
            memcpy(o, data + name_off[r], nl);
            o += nl;
            if (counts) {  // NULL = plain take-in-order records
                *o++ = (uint8_t)sep;
                o = put_i64(o, counts[k]);
            }
            *o++ = '\n';
            int32_t sl = seq_len[r];
            memcpy(o, data + seq_off[r], sl);
            o += sl;
            *o++ = '\n';
            *o++ = '+';
            *o++ = '\n';
            int32_t qreal = std::min(sl, qual_len[r]);
            memcpy(o, data + qual_off[r], qreal);
            if (qreal < sl) memset(o + qreal, 0, sl - qreal);
            o += sl;
            *o++ = '\n';
        }
    });
}

// ---------------------------------------------------------------------------
// Host dedup sort (host placement of ops/sortengine.dedup): stable
// lexicographic argsort of packed u32 key rows (+ optional length column
// as the least-significant key) with group-head marking. Used under
// NGSTPU_LINK=host (utils/placement.py); the device LSD engine is the
// default. Strategy: 256-way MSD scatter on the top byte
// of word0 (order-preserving), then per-bucket std::sort pulled off an
// atomic work queue; index tiebreak makes the whole thing stable.
// ---------------------------------------------------------------------------
void ngs_dedup_sort_host(const uint32_t* words, const int32_t* lens,
                         int use_len, int64_t b, int64_t W,
                         int32_t* perm, uint8_t* is_head, int nthreads) {
    if (b == 0) return;
    if (nthreads <= 0) nthreads = hw_threads();
    // bucket histogram + stable scatter by top byte
    std::vector<int64_t> counts(257, 0);
    for (int64_t i = 0; i < b; ++i) ++counts[(words[i * W] >> 24) + 1];
    for (int k = 0; k < 256; ++k) counts[k + 1] += counts[k];
    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t i = 0; i < b; ++i)
        perm[cursor[words[i * W] >> 24]++] = static_cast<int32_t>(i);
    std::atomic<int> next{0};
    parallel_ranges(nthreads, nthreads, [&](int64_t, int64_t, int) {
        std::vector<uint64_t> t0, t1;
        std::vector<int32_t> psnap;
        for (;;) {
            int k = next.fetch_add(1);
            if (k >= 256) return;
            // top byte fixed by the bucket scatter: radix the low 24 bits
            // of word0, recurse into later words on ties
            radix_rows(words, lens, use_len, W, perm, counts[k],
                       counts[k + 1], 0, 24, t0, t1, psnap);
        }
    });
    // group heads over the sorted order
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t k = lo; k < hi; ++k) {
            if (k == 0) { is_head[0] = 1; continue; }
            const uint32_t* ra = words + (int64_t)perm[k - 1] * W;
            const uint32_t* rc = words + (int64_t)perm[k] * W;
            bool same = memcmp(ra, rc, W * 4) == 0 &&
                        (!use_len || lens[perm[k - 1]] == lens[perm[k]]);
            is_head[k] = same ? 0 : 1;
        }
    });
}

// Sort + group extraction fused (host placement of the whole dedup): the
// same MSD scatter + per-bucket std::sort as ngs_dedup_sort_host, but each
// bucket's worker also extracts its groups while the rows are cache-hot:
// group size and representative row = earliest occurrence among the
// group's max-sumq rows (the strictly-greater replacement of reference
// gzfastq_uniq.c:224-229; the stable sort makes perm ascending within a
// group, so first-max-seen == earliest). Per-bucket results land at the
// bucket's row offset in rep/counts (groups <= rows per bucket, and a
// group never straddles buckets — the leading packed byte differs); one
// sequential in-place memmove pass packs them tight. Returns group count.
int64_t ngs_dedup_groups_host(const uint32_t* words, const int32_t* lens,
                              const uint32_t* sumq, int use_len,
                              int64_t b, int64_t W, int32_t* perm,
                              int64_t* rep, int64_t* counts, int nthreads) {
    if (b == 0) return 0;
    if (nthreads <= 0) nthreads = hw_threads();
    std::vector<int64_t> boff(257, 0);
    for (int64_t i = 0; i < b; ++i) ++boff[(words[i * W] >> 24) + 1];
    for (int k = 0; k < 256; ++k) boff[k + 1] += boff[k];
    std::vector<int64_t> cursor(boff.begin(), boff.end() - 1);
    for (int64_t i = 0; i < b; ++i)
        perm[cursor[words[i * W] >> 24]++] = static_cast<int32_t>(i);
    int64_t g_per[256] = {0};
    std::atomic<int> next{0};
    parallel_ranges(nthreads, nthreads, [&](int64_t, int64_t, int) {
        std::vector<uint64_t> t0, t1;
        std::vector<int32_t> psnap;
        for (;;) {
            int k = next.fetch_add(1);
            if (k >= 256) return;
            int64_t lo = boff[k], hi = boff[k + 1];
            if (lo == hi) continue;
            radix_rows(words, lens, use_len, W, perm, lo, hi, 0, 24,
                       t0, t1, psnap);
            int64_t* rp = rep + lo;
            int64_t* cp = counts + lo;
            int64_t g = 0, gstart = lo;
            uint32_t best_q = sumq[perm[lo]];
            int32_t best_row = perm[lo];
            for (int64_t i = lo + 1; i <= hi; ++i) {
                bool head = true;
                if (i < hi) {
                    const uint32_t* ra = words + (int64_t)perm[i - 1] * W;
                    const uint32_t* rc = words + (int64_t)perm[i] * W;
                    head = memcmp(ra, rc, W * 4) != 0 ||
                           (use_len && lens[perm[i - 1]] != lens[perm[i]]);
                }
                if (head) {
                    rp[g] = best_row;
                    cp[g] = i - gstart;
                    ++g;
                    if (i < hi) {
                        gstart = i;
                        best_q = sumq[perm[i]];
                        best_row = perm[i];
                    }
                } else {
                    uint32_t q = sumq[perm[i]];
                    if (q > best_q) { best_q = q; best_row = perm[i]; }
                }
            }
            g_per[k] = g;
        }
    });
    int64_t total = 0;
    for (int k = 0; k < 256; ++k) {
        int64_t base = boff[k];
        if (g_per[k] && base != total) {
            memmove(rep + total, rep + base, g_per[k] * 8);
            memmove(counts + total, counts + base, g_per[k] * 8);
        }
        total += g_per[k];
    }
    return total;
}

// Streamed single-bucket twin of ngs_dedup_groups_host (round 5): sorts
// perm[lo..hi) (top byte fixed by ngs_msd_scatter_u32) and extracts its
// groups at rep/counts + lo (a group never straddles buckets). A sorter
// thread walks buckets in ascending (== key) order so the uniq emit of
// bucket k overlaps the radix of bucket k+1. Returns the group count.
int64_t ngs_dedup_groups_range(const uint32_t* words, const int32_t* lens,
                               const uint32_t* sumq, int use_len,
                               int64_t W, int32_t* perm,
                               int64_t lo, int64_t hi,
                               int64_t* rep, int64_t* counts) {
    if (hi <= lo) return 0;
    std::vector<uint64_t> t0, t1;
    std::vector<int32_t> psnap;
    radix_rows(words, lens, use_len, W, perm, lo, hi, 0, 24, t0, t1, psnap);
    int64_t* rp = rep + lo;
    int64_t* cp = counts + lo;
    int64_t g = 0, gstart = lo;
    uint32_t best_q = sumq[perm[lo]];
    int32_t best_row = perm[lo];
    for (int64_t i = lo + 1; i <= hi; ++i) {
        bool head = true;
        if (i < hi) {
            const uint32_t* ra = words + (int64_t)perm[i - 1] * W;
            const uint32_t* rc = words + (int64_t)perm[i] * W;
            head = memcmp(ra, rc, W * 4) != 0 ||
                   (use_len && lens[perm[i - 1]] != lens[perm[i]]);
        }
        if (head) {
            rp[g] = best_row;
            cp[g] = i - gstart;
            ++g;
            if (i < hi) {
                gstart = i;
                best_q = sumq[perm[i]];
                best_row = perm[i];
            }
        } else {
            uint32_t q = sumq[perm[i]];
            if (q > best_q) { best_q = q; best_row = perm[i]; }
        }
    }
    return g;
}

// pick_pair merge-join over two offset-indexed name-sorted files
// (reference pick_pair.c:104-118 loop structure, ported index-based: one
// record from EACH side per outer iteration, each side advanced past
// smaller-keyed records into its SE list, then whatever two records
// remain are paired). Keys are the name line to its first space,
// compared byte-lex with shorter-key-first ties (the padded-S-bytes
// order of the generic python path). A side that runs out mid-iteration
// keeps the surviving side flowing to PE (the documented guard replacing
// the reference's NULL dereference). pe1/se1 sized n1, pe2/se2 sized n2;
// counts land in out_counts[4] = {n_pe1, n_se1, n_pe2, n_se2}.
void ngs_pick_pair_join(const uint8_t* d1, const int64_t* off1,
                        const int32_t* len1, int64_t n1,
                        const uint8_t* d2, const int64_t* off2,
                        const int32_t* len2, int64_t n2,
                        int32_t* pe1, int32_t* se1,
                        int32_t* pe2, int32_t* se2, int64_t* out_counts) {
    std::vector<int32_t> k1(n1), k2(n2);  // key length = to first space
    parallel_ranges(n1, 0, [&](int64_t lo, int64_t hi, int) {
        for (int64_t r = lo; r < hi; ++r) {
            const uint8_t* p = d1 + off1[r];
            const void* sp = memchr(p, ' ', len1[r]);
            k1[r] = sp ? (int32_t)((const uint8_t*)sp - p) : len1[r];
        }
    });
    parallel_ranges(n2, 0, [&](int64_t lo, int64_t hi, int) {
        for (int64_t r = lo; r < hi; ++r) {
            const uint8_t* p = d2 + off2[r];
            const void* sp = memchr(p, ' ', len2[r]);
            k2[r] = sp ? (int32_t)((const uint8_t*)sp - p) : len2[r];
        }
    });
    auto cmp = [&](int64_t a, int64_t b) -> int {
        int32_t la = k1[a], lb = k2[b];
        int32_t m = la < lb ? la : lb;
        int c = memcmp(d1 + off1[a], d2 + off2[b], m);
        if (c) return c;
        return la < lb ? -1 : (la > lb ? 1 : 0);
    };
    int64_t npe1 = 0, nse1 = 0, npe2 = 0, nse2 = 0;
    int64_t i = 0, j = 0;
    for (;;) {
        int64_t l1 = i < n1 ? i : -1;
        int64_t l2 = j < n2 ? j : -1;
        ++i;
        ++j;
        while (l1 >= 0 && l2 >= 0 && cmp(l1, l2) < 0) {
            se1[nse1++] = (int32_t)l1;
            l1 = i < n1 ? i : -1;
            ++i;
        }
        while (l2 >= 0 && l1 >= 0 && cmp(l1, l2) > 0) {
            se2[nse2++] = (int32_t)l2;
            l2 = j < n2 ? j : -1;
            ++j;
        }
        if (l1 < 0 && l2 < 0) break;
        if (l1 >= 0) pe1[npe1++] = (int32_t)l1;
        if (l2 >= 0) pe2[npe2++] = (int32_t)l2;
    }
    out_counts[0] = npe1;
    out_counts[1] = nse1;
    out_counts[2] = npe2;
    out_counts[3] = nse2;
}

// Record sizes + exclusive-prefix output offsets for the dedup emit
// (name\t{count}\nseq\n+\nqual\n, reference gzfastq_uniq.c:325-357).
// Returns total bytes. Sequential: ~3 gathers per group, memory-trivial.
// counts == NULL sizes plain records (no "\t{count}" suffix) — the
// take-in-order form gzfastq_sort's offset fast path emits.
int64_t ngs_uniq_sizes(const int32_t* name_len, const int32_t* seq_len,
                       const int64_t* rep, const int64_t* counts,
                       int64_t k_total, int64_t* out_starts) {
    int64_t acc = 0;
    for (int64_t k = 0; k < k_total; ++k) {
        out_starts[k] = acc;
        int64_t extra = 0;
        if (counts) {
            int64_t c = counts[k];
            int d = 1;
            while (c >= 10) { c /= 10; ++d; }
            extra = 1 + d;
        }
        int64_t r = rep[k];
        int64_t sl = seq_len[r];
        acc += name_len[r] + extra + 1 + sl + 3 + sl + 1;
    }
    return acc;
}

// 3-bit DNA rank packing for device sort keys (ranks . A C G N T = 1..6,
// 0 = padding; ten ranks per uint32, first rank most significant). Doing
// this on the host cuts device transfers 2.5x vs raw bytes. Full words are
// branchless straight-line lookups; only the final partial word bounds-checks.
void ngs_dna3_pack(const uint8_t* seq, int64_t b, int64_t lmax,
                   int64_t words, uint32_t* out, int nthreads) {
    static uint8_t rank[256];
    static bool init = false;
    if (!init) {
        memset(rank, 0, sizeof(rank));
        const char* alpha = ".ACGNT";
        for (int i = 0; i < 6; ++i) rank[(uint8_t)alpha[i]] = i + 1;
        init = true;
    }
    if (nthreads <= 0) nthreads = hw_threads();
    int64_t full = lmax / 10;  // words fully inside the row
    if (full > words) full = words;
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* row = seq + i * lmax;
            uint32_t* o = out + i * words;
            const uint8_t* p = row;
            for (int64_t w = 0; w < full; ++w, p += 10) {
                uint32_t acc = (uint32_t)rank[p[0]];
                acc = (acc << 3) | rank[p[1]];
                acc = (acc << 3) | rank[p[2]];
                acc = (acc << 3) | rank[p[3]];
                acc = (acc << 3) | rank[p[4]];
                acc = (acc << 3) | rank[p[5]];
                acc = (acc << 3) | rank[p[6]];
                acc = (acc << 3) | rank[p[7]];
                acc = (acc << 3) | rank[p[8]];
                acc = (acc << 3) | rank[p[9]];
                o[w] = acc;
            }
            int64_t pos = full * 10;
            for (int64_t w = full; w < words; ++w) {
                uint32_t acc = 0;
                for (int k = 0; k < 10; ++k, ++pos) {
                    uint32_t r = (pos < lmax) ? rank[row[pos]] : 0;
                    acc = (acc << 3) | r;
                }
                o[w] = acc;
            }
        }
    });
}

// dna3 collation pack straight from record offsets — the gzfastq_sort
// fast path's key builder without the padded intermediate (a full
// fill_padded pass over every byte). Returns 0 when every sequence byte
// was in {.ACGNT} (the 3-bit collation alphabet), 1 otherwise (caller
// falls back to raw byte keys; out contents are then unspecified).
int ngs_dna3_pack_ofs(const uint8_t* data, const int64_t* offs,
                      const int32_t* lens, int64_t b, int64_t words,
                      uint32_t* out, int nthreads) {
    static uint8_t rank[256];
    static uint8_t bad[256];
    static bool init = false;
    if (!init) {
        memset(rank, 0, sizeof(rank));
        memset(bad, 1, sizeof(bad));
        const char* alpha = ".ACGNT";
        for (int i = 0; i < 6; ++i) {
            rank[(uint8_t)alpha[i]] = i + 1;
            bad[(uint8_t)alpha[i]] = 0;
        }
        init = true;
    }
    if (nthreads <= 0) nthreads = hw_threads();
    std::atomic<int> any_bad{0};
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int) {
        int badrow = 0;
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* p = data + offs[i];
            int64_t l = lens[i];
            uint32_t* o = out + i * words;
            int64_t full = l / 10 < words ? l / 10 : words;
            for (int64_t w = 0; w < full; ++w, p += 10) {
                uint32_t acc = (uint32_t)rank[p[0]];
                badrow |= bad[p[0]] | bad[p[1]] | bad[p[2]] | bad[p[3]]
                    | bad[p[4]] | bad[p[5]] | bad[p[6]] | bad[p[7]]
                    | bad[p[8]] | bad[p[9]];
                acc = (acc << 3) | rank[p[1]];
                acc = (acc << 3) | rank[p[2]];
                acc = (acc << 3) | rank[p[3]];
                acc = (acc << 3) | rank[p[4]];
                acc = (acc << 3) | rank[p[5]];
                acc = (acc << 3) | rank[p[6]];
                acc = (acc << 3) | rank[p[7]];
                acc = (acc << 3) | rank[p[8]];
                acc = (acc << 3) | rank[p[9]];
                o[w] = acc;
            }
            int64_t pos = full * 10;
            const uint8_t* row = data + offs[i];
            for (int64_t w = full; w < words; ++w) {
                uint32_t acc = 0;
                for (int k = 0; k < 10; ++k, ++pos) {
                    uint32_t r = 0;
                    if (pos < l) {
                        r = rank[row[pos]];
                        badrow |= bad[row[pos]];
                    }
                    acc = (acc << 3) | r;
                }
                o[w] = acc;
            }
        }
        if (badrow) any_bad.store(1, std::memory_order_relaxed);
    });
    return any_bad.load();
}

// 2-bit DNA rank packing (ranks A C G T = 0..3, 16 per uint32, first base
// most significant). Valid only when the caller proved the buffer holds
// nothing but {A, C, G, T} and NUL padding: byte order == rank order, and
// the padding/'A' rank collision is disambiguated by the explicit length
// key the dedup sort always carries for 2-bit words. 5x narrower than raw
// bytes -> 5x less host->device traffic and 30% fewer LSD sort passes.
void ngs_dna2_pack(const uint8_t* seq, int64_t b, int64_t lmax,
                   int64_t words, uint32_t* out, int nthreads) {
    static uint8_t rank[256];
    static bool init = false;
    if (!init) {
        memset(rank, 0, sizeof(rank));
        rank[(uint8_t)'C'] = 1;
        rank[(uint8_t)'G'] = 2;
        rank[(uint8_t)'T'] = 3;
        init = true;
    }
    if (nthreads <= 0) nthreads = hw_threads();
    int64_t full = lmax / 16;
    if (full > words) full = words;
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* row = seq + i * lmax;
            uint32_t* o = out + i * words;
            const uint8_t* p = row;
            for (int64_t w = 0; w < full; ++w, p += 16) {
                uint32_t acc = 0;
                for (int k = 0; k < 16; ++k) acc = (acc << 2) | rank[p[k]];
                o[w] = acc;
            }
            int64_t pos = full * 16;
            for (int64_t w = full; w < words; ++w) {
                uint32_t acc = 0;
                for (int k = 0; k < 16; ++k, ++pos) {
                    uint32_t r = (pos < lmax) ? rank[row[pos]] : 0;
                    acc = (acc << 2) | r;
                }
                o[w] = acc;
            }
        }
    });
}

// 256-slot byte-presence bitmap over a buffer (the alphabet check for the
// 3-bit packing), parallel single pass. present[] is OR-accumulated.
void ngs_byte_presence(const uint8_t* data, int64_t n, uint8_t* present,
                       int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    nthreads = static_cast<int>(std::max<int64_t>(
        1, std::min<int64_t>(nthreads, (n + (1 << 20) - 1) >> 20)));
    std::vector<std::array<uint8_t, 256>> parts(nthreads);
    for (auto& a : parts) a.fill(0);
    parallel_ranges(n, nthreads, [&](int64_t lo, int64_t hi, int t) {
        uint8_t* pr = parts[t].data();
        for (int64_t i = lo; i < hi; ++i) pr[data[i]] = 1;
    });
    for (int t = 0; t < nthreads; ++t)
        for (int j = 0; j < 256; ++j) present[j] |= parts[t][j];
}

// ---------------------------------------------------------------------------
// Host QC histogram: the reference hot loop (fastq_count.c:106-133
// AssignQuality/count_read) as a threaded single pass. Used under
// NGSTPU_LINK=host (the device kernels are the default path). Semantics
// mirror ops/count.qc_histograms exactly: cycles beyond n_len-1 and quality
// bytes >= n_qual are dropped; the length histogram clips to n_len-1.
// hist_q: u64 [n_len, n_qual] (cycle-major); hist_len: u64 [n_len]; both
// ACCUMULATED INTO (caller zeroes or chains files).
// ---------------------------------------------------------------------------
void ngs_qc_hist(const uint8_t* qual, const int32_t* lens, int64_t b,
                 int64_t lmax, int64_t n_qual, int64_t n_len,
                 uint64_t* hist_q, uint64_t* hist_len, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    nthreads = static_cast<int>(std::max<int64_t>(
        1, std::min<int64_t>(nthreads, (b + 4095) / 4096)));
    std::vector<std::vector<uint64_t>> part_q(
        nthreads, std::vector<uint64_t>(n_len * n_qual, 0));
    std::vector<std::vector<uint64_t>> part_l(
        nthreads, std::vector<uint64_t>(n_len, 0));
    int64_t col_cap = std::min(lmax, n_len);
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int t) {
        uint64_t* hq = part_q[t].data();
        uint64_t* hl = part_l[t].data();
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* row = qual + i * lmax;
            int64_t len = lens[i];
            int64_t lim = std::min(len, col_cap);
            for (int64_t k = 0; k < lim; ++k) {
                uint8_t q = row[k];
                if (q < n_qual) ++hq[k * n_qual + q];
            }
            int64_t lbin = len < 0 ? 0 : (len >= n_len ? n_len - 1 : len);
            ++hl[lbin];
        }
    });
    for (int t = 0; t < nthreads; ++t) {
        for (int64_t j = 0; j < n_len * n_qual; ++j) hist_q[j] += part_q[t][j];
        for (int64_t j = 0; j < n_len; ++j) hist_len[j] += part_l[t][j];
    }
}

// Per-row byte sums (quality sums for dedup representative selection);
// padding bytes are zero so no mask is needed.
void ngs_row_sums_u32(const uint8_t* data, int64_t b, int64_t lmax,
                      uint32_t* out, int nthreads) {
    if (nthreads <= 0) nthreads = hw_threads();
    parallel_ranges(b, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* row = data + i * lmax;
            uint32_t s = 0;
            for (int64_t k = 0; k < lmax; ++k) s += row[k];
            out[i] = s;
        }
    });
}

// ---------------------------------------------------------------------------
// BAM record scanning (columnar decode)
//
// Plays the role of samtools' bam_read1 / bam_fetch record iteration
// (vendored samtools-0.1.19 sam.h/bam.c in the reference) but emits
// structure-of-arrays the device pipeline consumes directly: fixed fields,
// flattened cigar, per-record GC counts from the 4-bit packed bases.
// ---------------------------------------------------------------------------

// Pass 1: count records and total cigar ops in a decompressed alignment
// section buf[0..n), validating each fully-contained record's internal
// lengths against its block_size so pass 2 can never read out of bounds.
// Returns 0 on success, 1 on a trailing partial record (legitimate when
// the caller decoded a BAI-bounded block range), 2 on a malformed record
// (claimed name/cigar/seq sizes exceed block_size — fuzzed/corrupt input).
int ngs_bam_count(const uint8_t* buf, int64_t n, int64_t* n_rec,
                  int64_t* n_cigar_total) {
    int64_t o = 0, rec = 0, cig = 0;
    while (o + 4 <= n) {
        uint32_t bs;
        memcpy(&bs, buf + o, 4);
        if (o + 4 + bs > (uint64_t)n) break;
        if (bs < 32) { *n_rec = rec; *n_cigar_total = cig; return 2; }
        const uint8_t* r = buf + o + 4;
        uint8_t l_read_name = r[8];
        uint16_t n_cigar;
        memcpy(&n_cigar, r + 12, 2);
        int32_t l_seq;
        memcpy(&l_seq, r + 16, 4);
        if (l_read_name < 1 || l_seq < 0 ||
            32 + (int64_t)l_read_name + 4 * (int64_t)n_cigar +
                    ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq > (int64_t)bs) {
            *n_rec = rec;
            *n_cigar_total = cig;
            return 2;
        }
        cig += n_cigar;
        ++rec;
        o += 4 + bs;
    }
    *n_rec = rec;
    *n_cigar_total = cig;
    return (o == n) ? 0 : 1;
}

// Fused M-run event extraction for the event-mode pileup path
// (io/bam.py stream_pileup_events): one pass over a chunk of BAM record
// bytes emitting (tid, start, end) per CIGAR M run of records passing the
// flag mask — the per-read hash-insert loop of the reference
// (bam2depth.c:86-110) as a single branch-light walk that never touches
// the sequence/quality bytes (unlike the full columnar scan, whose GC
// pass reads every base). Caller sizes the out arrays at
// `cap` sizes the out arrays; the walk stops cleanly at a record whose
// cigar could overflow them and returns 3 with *consumed at that record's
// start — the caller drains the events and re-invokes on the remainder,
// which removes the separate ngs_bam_count sizing pre-walk (one fewer
// full pass over the record bytes). mono_state[2] = {monotone flag,
// last passing tid} persists across chunks (the early-emission tracking
// of the python grouping loop). Returns 0 (all bytes consumed), 1
// (trailing partial record; *consumed set), 2 (malformed record),
// 3 (out arrays full; *consumed set at a record boundary).
int ngs_bam_m_events(const uint8_t* buf, int64_t n, int32_t n_refs,
                     int32_t flag_mask, int32_t* out_tid,
                     int32_t* out_start, int32_t* out_end, int64_t cap,
                     int64_t* n_events, int64_t* consumed,
                     int32_t* mono_state) {
    int64_t o = 0, ev = 0;
    int32_t mono = mono_state[0], last_tid = mono_state[1];
    while (o + 4 <= n) {
        uint32_t bs;
        memcpy(&bs, buf + o, 4);
        if (o + 4 + bs > (uint64_t)n) break;
        // the walk strides ~200B (headers + cigar only, seq/qual skipped)
        // — prefetch the next record's header + cigar lines so the loop
        // isn't serialized on demand misses over the 1.7GB body
        __builtin_prefetch(buf + o + 4 + bs);
        __builtin_prefetch(buf + o + 4 + bs + 64);
        if (bs < 32) {
            *n_events = ev; *consumed = o;
            mono_state[0] = mono; mono_state[1] = last_tid;
            return 2;
        }
        const uint8_t* r = buf + o + 4;
        uint8_t l_read_name = r[8];
        uint16_t n_cigar, flag;
        memcpy(&n_cigar, r + 12, 2);
        memcpy(&flag, r + 14, 2);
        if (ev + (int64_t)n_cigar > cap) {
            *n_events = ev; *consumed = o;
            mono_state[0] = mono; mono_state[1] = last_tid;
            return 3;
        }
        int32_t l_seq;
        memcpy(&l_seq, r + 16, 4);
        if (l_read_name < 1 || l_seq < 0 ||
            32 + (int64_t)l_read_name + 4 * (int64_t)n_cigar +
                    ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq > (int64_t)bs) {
            *n_events = ev; *consumed = o;
            mono_state[0] = mono; mono_state[1] = last_tid;
            return 2;
        }
        int32_t tid, pos;
        memcpy(&tid, r, 4);
        memcpy(&pos, r + 4, 4);
        // tid outside the header is skipped entirely (including the
        // monotone tracking) exactly like ngs_bam_depth_scan — otherwise
        // one corrupt tid would poison last_tid and silently flush every
        // later chromosome early
        if ((flag & flag_mask) == 0 && tid >= 0 && tid < n_refs) {
            if (mono && tid < last_tid) mono = 0;
            if (mono) last_tid = tid;
            const uint8_t* cg = r + 32 + l_read_name;
            int32_t off = 0;
            for (uint16_t k = 0; k < n_cigar; ++k) {
                uint32_t c;
                memcpy(&c, cg + 4 * k, 4);
                uint32_t op = c & 0xF;
                int32_t ln = (int32_t)(c >> 4);
                if (op == 0) {  // M: emit block, advance
                    out_tid[ev] = tid;
                    out_start[ev] = pos + off;
                    out_end[ev] = pos + off + ln;
                    ++ev;
                    off += ln;
                } else if (op == 2 || op == 3) {  // D/N advance only
                    off += ln;
                }  // I/S/H/P/=/X: no reference advance (bam2depth.c:94-107)
            }
        }
        o += 4 + bs;
    }
    *n_events = ev;
    *consumed = o;
    mono_state[0] = mono;
    mono_state[1] = last_tid;
    return (o == n) ? 0 : 1;
}

// Pass 2: fill columnar outputs (caller sized them from ngs_bam_count).
// gc counts bases whose 4-bit code is 2 (C) or 4 (G)
// (reference bam_sliding_count.c:84-91 cal_GC).
void ngs_bam_scan(const uint8_t* buf, int64_t n,
                  int64_t* rec_offset, int32_t* rec_len,
                  int32_t* tid, int32_t* pos, int32_t* flag, int32_t* mapq,
                  int32_t* l_qseq, int32_t* gc,
                  int64_t* cigar_offset, int32_t* n_cigar_out,
                  uint8_t* cigar_op, uint32_t* cigar_len,
                  int nthreads) {
    // sequential offset walk (cheap), then parallel field extraction.
    // Stop conditions mirror ngs_bam_count exactly (the caller sized the
    // output arrays from it), including the malformed-record validation.
    int64_t o = 0, rec = 0, cig = 0;
    while (o + 4 <= n) {
        uint32_t bs;
        memcpy(&bs, buf + o, 4);
        if (o + 4 + bs > (uint64_t)n) break;
        if (bs < 32) break;
        const uint8_t* r = buf + o + 4;
        uint8_t l_read_name = r[8];
        uint16_t nc;
        memcpy(&nc, r + 12, 2);
        int32_t l_seq;
        memcpy(&l_seq, r + 16, 4);
        if (l_read_name < 1 || l_seq < 0 ||
            32 + (int64_t)l_read_name + 4 * (int64_t)nc +
                    ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq > (int64_t)bs)
            break;
        rec_offset[rec] = o;
        rec_len[rec] = (int32_t)(4 + bs);
        cigar_offset[rec] = cig;
        n_cigar_out[rec] = nc;
        cig += nc;
        ++rec;
        o += 4 + bs;
    }
    if (nthreads <= 0) nthreads = hw_threads();
    static const int8_t GC_NIBBLE[16] = {0,0,1,0, 1,0,0,0, 0,0,0,0, 0,0,0,0};
    parallel_ranges(rec, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* r = buf + rec_offset[i] + 4;
            int32_t v;
            memcpy(&v, r, 4);      tid[i] = v;
            memcpy(&v, r + 4, 4);  pos[i] = v;
            uint8_t l_read_name = r[8];
            mapq[i] = r[9];
            uint16_t fl, nc;
            memcpy(&nc, r + 12, 2);
            memcpy(&fl, r + 14, 2);
            flag[i] = fl;
            memcpy(&v, r + 16, 4); l_qseq[i] = v;
            const uint8_t* p = r + 32 + l_read_name;
            uint8_t* ops = cigar_op + cigar_offset[i];
            uint32_t* lens = cigar_len + cigar_offset[i];
            for (int k = 0; k < nc; ++k) {
                uint32_t cg;
                memcpy(&cg, p + 4 * k, 4);
                ops[k] = cg & 0xF;
                lens[k] = cg >> 4;
            }
            const uint8_t* seq = p + 4 * nc;
            int32_t ls = l_qseq[i];
            int32_t g = 0;
            for (int32_t k = 0; k < ls / 2; ++k) {
                g += GC_NIBBLE[seq[k] >> 4] + GC_NIBBLE[seq[k] & 0xF];
            }
            if (ls & 1) g += GC_NIBBLE[seq[ls / 2] >> 4];
            gc[i] = g;
        }
    });
}

// ---------------------------------------------------------------------------
// Host pileup sweep (transfer-aware fallback for ops/bamops.py
// sparse_pileup_sweep): sort (pos, delta) events by position, accumulate
// the running depth, and emit one (pos, cumulative depth) row per unique
// position — exactly the device kernel's is_last rows. Each event packs
// into one int64 (sign-biased pos << 32 | biased delta); the sort is a
// 2-pass LSD radix over the two 16-bit position digits (the delta bits
// never need ordering — depth is a sum over equal positions), ~10x a
// comparison sort on the multi-million-event chromosomes the event-mode
// bam2depth path feeds here (the hash+qsort this replaces:
// reference bam2depth.c:203-236, hashtbl.c:275-297).
// Returns the number of unique positions; u_pos/u_depth sized >= n by caller.
// ---------------------------------------------------------------------------
// Specialized sweep for runs laid out as (starts, ends) — the event-mode
// pileup layout. Starts from a coordinate-sorted BAM are MOSTLY ascending
// (every record's first M run begins at its ascending pos; only later
// runs of multi-M cigars jump ahead), so one pass splits them into the
// greedy nondecreasing main stream plus an "extras" remainder; only the
// extras and the ends pay the 2x16-bit radix, and the sweep is a 3-way
// merge. Fully general: any starts order works (worst case everything is
// an extra and the cost matches ngs_pileup_sweep). Output is identical to
// ngs_pileup_sweep over the combined (+1/-1) events.
static void radix_sort_i32(std::vector<int32_t>& v) {
    int64_t n = (int64_t)v.size();
    if (n < 2) return;
    // thread_local scratch: see ngs_pileup_emit_se (fault once, reuse
    // across the per-chromosome calls)
    thread_local std::vector<int32_t> tmp;
    thread_local std::vector<int64_t> hist;
    tmp.resize(n);
    hist.resize(1 << 16);
    for (int64_t i = 0; i < n; ++i)
        v[i] = (int32_t)(((uint32_t)v[i]) ^ 0x80000000u);
    int32_t* src = v.data();
    int32_t* dst = tmp.data();
    for (int shift = 0; shift < 32; shift += 16) {
        std::fill(hist.begin(), hist.end(), 0);
        for (int64_t i = 0; i < n; ++i)
            ++hist[((uint32_t)src[i] >> shift) & 0xFFFF];
        int64_t run = 0;
        for (int64_t d = 0; d < (1 << 16); ++d) {
            int64_t c = hist[d];
            hist[d] = run;
            run += c;
        }
        for (int64_t i = 0; i < n; ++i)
            dst[hist[((uint32_t)src[i] >> shift) & 0xFFFF]++] = src[i];
        std::swap(src, dst);
    }
    for (int64_t i = 0; i < n; ++i)
        v[i] = (int32_t)(((uint32_t)v[i]) ^ 0x80000000u);
}

int64_t ngs_pileup_sweep_se(const int32_t* starts, const int32_t* ends,
                            int64_t n, int64_t* u_pos, int64_t* u_depth,
                            int nthreads) {
    (void)nthreads;
    if (n == 0) return 0;
    // greedy monotone cover of starts: main (ascending in place order)
    // vs extras (later multi-M runs overtaken by the running max)
    std::vector<int32_t> main_s;
    std::vector<int32_t> extra_s;
    main_s.reserve(n);
    int32_t run_max = starts[0];
    for (int64_t i = 0; i < n; ++i) {
        if (starts[i] >= run_max) {
            run_max = starts[i];
            main_s.push_back(starts[i]);
        } else {
            extra_s.push_back(starts[i]);
        }
    }
    radix_sort_i32(extra_s);
    std::vector<int32_t> se(ends, ends + n);
    radix_sort_i32(se);
    // 3-way merge sweep over (main_s, extra_s, se)
    int64_t i = 0, j = 0, k = 0, out = 0, depth = 0;
    int64_t nm = (int64_t)main_s.size(), ne = (int64_t)extra_s.size();
    bool first = true;
    int64_t cur = 0;
    while (i < nm || j < ne || k < n) {
        int64_t p;
        int64_t d;
        int32_t pm = i < nm ? main_s[i] : 0;
        int32_t pe = j < ne ? extra_s[j] : 0;
        bool take_main = i < nm && (j >= ne || pm <= pe);
        int32_t ps = take_main ? pm : pe;
        bool have_s = (i < nm) || (j < ne);
        if (have_s && (k >= n || ps <= se[k])) {
            p = ps;
            d = 1;
            if (take_main) ++i; else ++j;
        } else {
            p = se[k++];
            d = -1;
        }
        if (first) { cur = p; first = false; }
        if (p != cur) {
            u_pos[out] = cur;
            u_depth[out++] = depth;
            cur = p;
        }
        depth += d;
    }
    u_pos[out] = cur;
    u_depth[out++] = depth;
    return out;
}

// Host sort permutation over packed collation words — the placement-aware
// host twin of ops/sortengine.lex_argsort for gzfastq_sort (reference
// comparators gzfastq_sort.c:85-103: length primary, then byte compare;
// equal keys keep input order like glibc's stable qsort). len_first != 0
// puts the length before the words in the key. 256-way MSD bucket scatter
// (by clamped length or by the leading packed byte) then parallel
// per-bucket std::sort — the same shape as ngs_dedup_groups_host.
void ngs_sort_perm_host(const uint32_t* words, const int32_t* lens,
                        int64_t b, int64_t W, int len_first,
                        int32_t* perm, int nthreads) {
    if (b == 0) return;
    if (nthreads <= 0) nthreads = hw_threads();
    std::vector<int64_t> boff(257, 0);
    auto bucket_of = [&](int64_t i) -> int {
        if (len_first) {
            int32_t l = lens[i];
            return l < 0 ? 0 : (l > 255 ? 255 : (int)l);
        }
        return (int)(words[i * W] >> 24);
    };
    for (int64_t i = 0; i < b; ++i) ++boff[bucket_of(i) + 1];
    for (int k = 0; k < 256; ++k) boff[k + 1] += boff[k];
    std::vector<int64_t> cursor(boff.begin(), boff.end() - 1);
    for (int64_t i = 0; i < b; ++i)
        perm[cursor[bucket_of(i)]++] = static_cast<int32_t>(i);
    // key order mirrors lex_argsort exactly: (lens if len_first), words,
    // original index. len_first == 0 uses ONLY the words (lens is not a
    // key there — lex_argsort's callers encode length in the words or
    // don't need it).
    auto cmp = [&](int32_t a, int32_t c) {
        if (len_first && lens[a] != lens[c]) return lens[a] < lens[c];
        const uint32_t* ra = words + (int64_t)a * W;
        const uint32_t* rc = words + (int64_t)c * W;
        for (int64_t w = 0; w < W; ++w) {
            if (ra[w] != rc[w]) return ra[w] < rc[w];
        }
        return a < c;  // stability
    };
    std::atomic<int> next{0};
    parallel_ranges(nthreads, nthreads, [&](int64_t, int64_t, int) {
        std::vector<uint64_t> t0, t1;
        std::vector<int32_t> psnap;
        for (;;) {
            int k = next.fetch_add(1);
            if (k >= 256) return;
            int64_t lo = boff[k], hi = boff[k + 1];
            if (hi - lo <= 1) continue;
            if (len_first && k == 255) {
                // clamped-length bucket: lengths may differ inside it, and
                // length is the PRIMARY key here — radix on word0 would
                // reorder; comparison sort keeps the collation
                std::sort(perm + lo, perm + hi, cmp);
            } else {
                // len_first: lengths equal within bucket -> words decide;
                // otherwise bucket fixed word0's top byte: radix low 24
                radix_rows(words, nullptr, 0, W, perm, lo, hi, 0,
                           len_first ? 32 : 24, t0, t1, psnap);
            }
        }
    });
}

// Streamed variant of ngs_sort_perm_host for constant-length inputs
// (lex order == length-first order there): the MSD scatter and the
// per-bucket radix are split into two entry points so a sorter thread
// can hand each finished bucket range to the emitter while later
// buckets still sort — the sort stage leaves the tool's critical path
// (round 5; the emit of bucket k overlaps the radix of bucket k+1).
void ngs_msd_scatter_u32(const uint32_t* words, int64_t b, int64_t W,
                         int32_t* perm, int64_t* boff257) {
    for (int k = 0; k <= 256; ++k) boff257[k] = 0;
    for (int64_t i = 0; i < b; ++i) ++boff257[(words[i * W] >> 24) + 1];
    for (int k = 0; k < 256; ++k) boff257[k + 1] += boff257[k];
    std::vector<int64_t> cursor(boff257, boff257 + 256);
    for (int64_t i = 0; i < b; ++i)
        perm[cursor[words[i * W] >> 24]++] = static_cast<int32_t>(i);
}

// Sort one scattered bucket range perm[lo..hi) (top byte of word0 fixed
// by the scatter): radix over the low 24 bits, recursing into later
// words on ties. Thread-safe across disjoint ranges.
void ngs_sort_perm_range(const uint32_t* words, int64_t W,
                         int32_t* perm, int64_t lo, int64_t hi) {
    std::vector<uint64_t> t0, t1;
    std::vector<int32_t> psnap;
    radix_rows(words, nullptr, 0, W, perm, lo, hi, 0, 24, t0, t1, psnap);
}

// Fully fused event-mode emitter: the ngs_pileup_sweep_se merge PLUS the
// interval merge (_intervals_from_sweep), bedGraph row formatting
// (format_int3_rows) and the bam2depth window binning
// (ops/bamops.depth_window_bins) in ONE pass — no (u_pos, u_depth)
// int64 intermediates (hundreds of MB round-tripped through memory on a
// WGS run) and no separate numpy passes. Semantics are bit-identical to
// that python chain, including the window clamp quirks: bins must be
// float64[n_windows + 2] zeroed by the caller (two clamp slots the
// caller discards, exactly like depth_window_bins), every contribution
// is integer-valued so float64 accumulation order cannot matter, and
// rows match the reference's hash2BedGraph output (bam2depth.c:203-236)
// with output_bins overlap accounting (:132-176). Returns bytes written
// to text, or -1 when cap is short (callers size cap >= (2n+2) rows).
static inline int64_t floordiv_i64(int64_t a, int64_t w) {
    return a >= 0 ? a / w : -((-a + w - 1) / w);
}

int64_t ngs_pileup_emit_se(const int32_t* starts, const int32_t* ends,
                           int64_t n, const uint8_t* name, int32_t name_len,
                           int64_t window, double* bins, int64_t n_windows,
                           uint8_t* text, int64_t cap, int nthreads) {
    (void)nthreads;
    if (n == 0) return 0;
    // thread_local scratch: capacity persists across the per-chromosome
    // calls of a WGS run, so the ~3n of working ints fault exactly once
    // per process instead of per chromosome (this host's anonymous-page
    // faults are slow AND erratic — a measured variance source)
    thread_local std::vector<int32_t> main_s;
    thread_local std::vector<int32_t> extra_s;
    thread_local std::vector<int32_t> se;
    main_s.clear();
    extra_s.clear();
    main_s.reserve(n);
    int32_t run_max = starts[0];
    for (int64_t i = 0; i < n; ++i) {
        if (starts[i] >= run_max) {
            run_max = starts[i];
            main_s.push_back(starts[i]);
        } else {
            extra_s.push_back(starts[i]);
        }
    }
    radix_sort_i32(extra_s);
    se.assign(ends, ends + n);
    radix_sort_i32(se);

    uint8_t* o = text;
    uint8_t* const text_end = text + cap;
    // segment merger state: seg = [seg_start, ...) at depth seg_depth
    bool have_seg = false;
    int64_t seg_start = 0, seg_depth = 0;
    auto emit_unique = [&](int64_t p, int64_t d) -> bool {
        if (!have_seg) {
            seg_start = p;
            seg_depth = d;
            have_seg = true;
            return true;
        }
        if (d == seg_depth) return true;
        if (seg_depth > 0) {
            if (o + name_len + 70 > text_end) return false;
            memcpy(o, name, name_len);
            o += name_len;
            *o++ = '\t'; o = put_i64(o, seg_start);
            *o++ = '\t'; o = put_i64(o, p);
            *o++ = '\t'; o = put_i64(o, seg_depth);
            *o++ = '\n';
            if (window > 0 && bins) {
                // exact depth_window_bins arithmetic (incl. its clamp
                // behavior for coordinates outside [0, n_windows*W))
                const int64_t ls = seg_start, le = p, d0 = seg_depth;
                int64_t fw = floordiv_i64(ls, window);
                int64_t lw = floordiv_i64(le - 1, window);
                if (lw < fw) lw = fw;
                if (fw < 0) fw = 0;
                if (fw > n_windows + 1) fw = n_windows + 1;
                if (lw < 0) lw = 0;
                if (lw > n_windows + 1) lw = n_windows + 1;
                int64_t first_end = (fw + 1) * window;
                if (le < first_end) first_end = le;
                bins[fw] += (double)((first_end - ls) * d0);
                if (lw != fw) bins[lw] += (double)((le - lw * window) * d0);
                if (lw > fw + 1 && window * d0 != 0) {
                    const double wd = (double)(window * d0);
                    for (int64_t w = fw + 1; w < lw; ++w) bins[w] += wd;
                }
            }
        }
        seg_start = p;
        seg_depth = d;
        return true;
    };

    // 3-way merge sweep over (main_s, extra_s, se)
    int64_t i = 0, j = 0, k = 0, depth = 0;
    int64_t nm = (int64_t)main_s.size(), ne = (int64_t)extra_s.size();
    bool first = true;
    int64_t cur = 0;
    while (i < nm || j < ne || k < n) {
        int64_t p;
        int64_t d;
        int32_t pm = i < nm ? main_s[i] : 0;
        int32_t pe = j < ne ? extra_s[j] : 0;
        bool take_main = i < nm && (j >= ne || pm <= pe);
        int32_t ps = take_main ? pm : pe;
        bool have_s = (i < nm) || (j < ne);
        if (have_s && (k >= n || ps <= se[k])) {
            p = ps;
            d = 1;
            if (take_main) ++i; else ++j;
        } else {
            p = se[k++];
            d = -1;
        }
        if (first) { cur = p; first = false; }
        if (p != cur) {
            if (!emit_unique(cur, depth)) return -1;
            cur = p;
        }
        depth += d;
    }
    if (!emit_unique(cur, depth)) return -1;
    // trailing segment: _intervals_from_sweep drops it (no next boundary
    // to end it); final depth is 0 for well-formed start/end pairs anyway
    return o - text;
}

int64_t ngs_pileup_sweep(const int32_t* pos, const int32_t* delta, int64_t n,
                         int64_t* u_pos, int64_t* u_depth, int nthreads) {
    if (n == 0) return 0;
    int T = nthreads > 0 ? nthreads : static_cast<int>(hw_threads());
    if (T > 4) T = 4;
    if (n < (1 << 16)) T = 1;
    std::vector<int64_t> keys(n), tmp(n);
    std::vector<int64_t> bounds(T + 1);
    for (int t = 0; t <= T; ++t) bounds[t] = n * t / T;
    // pack + per-slice 2x16-bit LSD radix, slices in parallel; the sweep
    // below consumes the T sorted runs through a T-way merge (depth is a
    // sum over equal positions, so run order between equals is free)
    parallel_ranges(T, T, [&](int64_t lo_t, int64_t hi_t, int) {
        for (int64_t t = lo_t; t < hi_t; ++t) {
            int64_t lo = bounds[t], hi = bounds[t + 1];
            for (int64_t i = lo; i < hi; ++i) {
                uint32_t bp = static_cast<uint32_t>(pos[i]) ^ 0x80000000u;
                keys[i] =
                    (static_cast<int64_t>(static_cast<uint64_t>(bp)) << 32) |
                    static_cast<uint32_t>(delta[i] + (1 << 30));
            }
            std::vector<int64_t> hist(1 << 16);
            int64_t* src = keys.data();
            int64_t* dst = tmp.data();
            for (int shift = 32; shift < 64; shift += 16) {
                std::fill(hist.begin(), hist.end(), 0);
                for (int64_t i = lo; i < hi; ++i)
                    ++hist[(static_cast<uint64_t>(src[i]) >> shift) & 0xFFFF];
                int64_t run = lo;
                for (int64_t d = 0; d < (1 << 16); ++d) {
                    int64_t c = hist[d];
                    hist[d] = run;
                    run += c;
                }
                for (int64_t i = lo; i < hi; ++i)
                    dst[hist[(static_cast<uint64_t>(src[i]) >> shift) &
                             0xFFFF]++] = src[i];
                std::swap(src, dst);
            }
        }
    });
    // T-way merge sweep over the sorted (still sign-biased) runs
    std::vector<int64_t> idx(bounds.begin(), bounds.end() - 1);
    auto head = [&](int t) -> uint64_t {
        return static_cast<uint64_t>(keys[idx[t]]);
    };
    int64_t out = 0, depth = 0;
    bool first = true;
    int64_t cur = 0;
    for (int64_t done = 0; done < n; ++done) {
        int best = -1;
        uint64_t bk = 0;
        for (int t = 0; t < T; ++t) {
            if (idx[t] < bounds[t + 1]) {
                uint64_t k = head(t);
                if (best < 0 || k < bk) { best = t; bk = k; }
            }
        }
        int64_t p = static_cast<int64_t>(
            static_cast<int32_t>((bk >> 32) ^ 0x80000000u));
        if (first) { cur = p; first = false; }
        if (p != cur) {
            u_pos[out] = cur;
            u_depth[out++] = depth;
            cur = p;
        }
        depth += static_cast<int64_t>(static_cast<uint32_t>(bk & 0xFFFFFFFF)) -
                 (1 << 30);
        ++idx[best];
    }
    u_pos[out] = cur;
    u_depth[out++] = depth;
    return out;
}

// ---------------------------------------------------------------------------
// Fast TSV row formatting (bedGraph / window / wig emission)
// ---------------------------------------------------------------------------

// two-digit pair table: one division per two digits emitted — roughly
// halves the itoa cost of the bedGraph formatters, whose output is
// hundreds of MB of small integers on WGS runs.
static const char DIGIT_PAIRS[201] =
    "00010203040506070809101112131415161718192021222324"
    "25262728293031323334353637383940414243444546474849"
    "50515253545556575859606162636465666768697071727374"
    "75767778798081828384858687888990919293949596979899";

static inline uint8_t* put_i64(uint8_t* o, int64_t v) {
    if (v < 0) { *o++ = '-'; v = -v; }
    char tmp[24];
    int k = 24;
    uint64_t u = static_cast<uint64_t>(v);
    while (u >= 100) {
        uint64_t q = u / 100;
        memcpy(tmp + k - 2, DIGIT_PAIRS + 2 * (u - q * 100), 2);
        k -= 2;
        u = q;
    }
    if (u >= 10) {
        memcpy(tmp + k - 2, DIGIT_PAIRS + 2 * u, 2);
        k -= 2;
    } else {
        tmp[--k] = static_cast<char>('0' + u);
    }
    memcpy(o, tmp + k, 24 - k);
    return o + (24 - k);
}

// rows "prefix\tA\tB\tC\n" with integer columns; returns bytes written.
static inline int i64_len(int64_t v) {
    int l = (v < 0) ? 2 : 1;  // sign + first digit
    uint64_t u = static_cast<uint64_t>(v < 0 ? -v : v);
    while (u >= 10) { ++l; u /= 10; }
    return l;
}

int64_t ngs_format_int3_rows(const uint8_t* prefix, int32_t prefix_len,
                             const int64_t* a, const int64_t* b,
                             const int64_t* c, int64_t n, uint8_t* out,
                             int nthreads) {
    int T = nthreads > 0 ? nthreads : hw_threads();
    if (T > 8) T = 8;
    if (n < (1 << 15)) T = 1;
    if (T == 1) {
        uint8_t* o = out;
        for (int64_t i = 0; i < n; ++i) {
            memcpy(o, prefix, prefix_len);
            o += prefix_len;
            *o++ = '\t'; o = put_i64(o, a[i]);
            *o++ = '\t'; o = put_i64(o, b[i]);
            *o++ = '\t'; o = put_i64(o, c[i]);
            *o++ = '\n';
        }
        return o - out;
    }
    // two-pass parallel: per-range byte totals, prefix, then packed fill
    std::vector<int64_t> bounds(T + 1), offs(T + 1);
    for (int t = 0; t <= T; ++t) bounds[t] = n * t / T;
    parallel_ranges(T, T, [&](int64_t lo_t, int64_t hi_t, int) {
        for (int64_t t = lo_t; t < hi_t; ++t) {
            int64_t bytes = 0;
            for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i)
                bytes += prefix_len + 4 + i64_len(a[i]) + i64_len(b[i]) +
                         i64_len(c[i]);
            offs[t + 1] = bytes;
        }
    });
    offs[0] = 0;
    for (int t = 0; t < T; ++t) offs[t + 1] += offs[t];
    parallel_ranges(T, T, [&](int64_t lo_t, int64_t hi_t, int) {
        for (int64_t t = lo_t; t < hi_t; ++t) {
            uint8_t* o = out + offs[t];
            for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i) {
                memcpy(o, prefix, prefix_len);
                o += prefix_len;
                *o++ = '\t'; o = put_i64(o, a[i]);
                *o++ = '\t'; o = put_i64(o, b[i]);
                *o++ = '\t'; o = put_i64(o, c[i]);
                *o++ = '\n';
            }
        }
    });
    return offs[T];
}

// rows "prefix\tA\tB\tX.YZ\n" — last column fixed 2-decimal from
// pre-scaled hundredths (C printf %.2f semantics handled by caller's
// rounding; here v100 = round(value*100)).
int64_t ngs_format_int2_fixed2_rows(const uint8_t* prefix, int32_t prefix_len,
                                    const int64_t* a, const int64_t* b,
                                    const int64_t* v100, int64_t n,
                                    uint8_t* out) {
    uint8_t* o = out;
    for (int64_t i = 0; i < n; ++i) {
        memcpy(o, prefix, prefix_len);
        o += prefix_len;
        *o++ = '\t'; o = put_i64(o, a[i]);
        *o++ = '\t'; o = put_i64(o, b[i]);
        *o++ = '\t';
        int64_t v = v100[i];
        if (v < 0) { *o++ = '-'; v = -v; }
        o = put_i64(o, v / 100);
        *o++ = '.';
        *o++ = '0' + (v / 10) % 10;
        *o++ = '0' + v % 10;
        *o++ = '\n';
    }
    return o - out;
}

// ---------------------------------------------------------------------------
// Fused dense pileup (the bam2depth/bam2wig fast path)
// ---------------------------------------------------------------------------
// Instead of materializing (pos, ±1) event arrays and sorting them (the
// ngs_pileup_sweep fallback above), scatter CIGAR M-run bounds straight
// into dense per-reference delta arrays while scanning the records, then
// emit bedGraph rows + window bins from one prefix-sum pass. This is the
// capability of the reference's per-read pileup accumulation
// (bam2depth.c:90-107 + hash2BedGraph :203-236 + output_bins :238-246)
// restructured as two data-parallel passes with no intermediate sort.
//
// ngs_bam_depth_scan processes ONE inflated chunk of BAM record bytes.
// delta_ptrs[tid] is a caller-owned int32 array of cur_lens[tid] entries
// (zero-initialized); entries may be NULL until a chunk first touches the
// tid. The call first walks record offsets (also tracking whether the
// stream's passing-record tids stay nondecreasing in state[0]/state[1]),
// then validates in parallel that every touched tid has a large-enough
// array, reporting requirements in needed_len[tid] (max event end + 1,
// monotone nondecreasing across calls). If any allocation is missing or
// short it returns -2 WITHOUT scattering — the caller allocates/grows and
// calls again with the same chunk (the handshake keeps even
// beyond-reference-end alignments bit-identical to the event path).
// Otherwise it atomically scatters +1 at each M-run start and -1 at its
// end, adds per-tid M-run counts into ev_counts, and returns the number
// of bytes consumed by complete records (the caller carries the rest).
int64_t ngs_bam_depth_scan(const uint8_t* buf, int64_t n,
                           int32_t** delta_ptrs, const int64_t* cur_lens,
                           int32_t n_refs, int32_t flag_mask,
                           int64_t* needed_len, int64_t* ev_counts,
                           int32_t* state /* [monotone, last_tid] */,
                           int nthreads) {
    std::vector<int64_t> offs;
    offs.reserve(n / 64 + 1);
    int64_t o = 0;
    int32_t monotone = state[0], last_tid = state[1];
    while (o + 4 <= n) {
        uint32_t bs;
        memcpy(&bs, buf + o, 4);
        if (bs < 32 || o + 4 + (int64_t)bs > n) break;
        const uint8_t* r = buf + o + 4;
        uint8_t l_read_name = r[8];
        uint16_t nc;
        memcpy(&nc, r + 12, 2);
        int32_t l_seq;
        memcpy(&l_seq, r + 16, 4);
        if (l_read_name < 1 || l_seq < 0 ||
            32 + (int64_t)l_read_name + 4 * (int64_t)nc +
                    ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq > (int64_t)bs)
            break;
        int32_t tid;
        uint16_t fl;
        memcpy(&tid, r, 4);
        memcpy(&fl, r + 14, 2);
        if ((fl & flag_mask) == 0 && tid >= 0 && tid < n_refs) {
            if (tid < last_tid) monotone = 0;
            last_tid = tid;
        }
        offs.push_back(o);
        o += 4 + (int64_t)bs;
    }
    state[0] = monotone;
    state[1] = last_tid;
    const int64_t rec = (int64_t)offs.size();
    if (nthreads <= 0) nthreads = hw_threads();

    // Fast mode (state[2] == 1, set when the caller preallocated every
    // array at >= ref_len+1): skip the validation pass, scatter directly
    // with a per-run bounds check. Out-of-range runs (alignments past the
    // declared reference end, or tids the caller freed — both rare) spill
    // into `needed_len` reinterpreted as a (tid, start, len) triple list
    // the caller applies itself after growing: needed_len[0] = triple
    // capacity on entry, replaced by the spill count on exit (so
    // needed_len must be sized >= max(n_refs, 1 + 3*cap)). If the spill
    // count exceeds the capacity the call returns -3 with all in-range
    // runs already applied; the caller undoes them exactly by re-invoking
    // with state[2] == -1 (same walk, inverted sign, spills ignored) and
    // then falls back to the handshake passes below.
    if (state[2]) {
        const int32_t sg = state[2] < 0 ? -1 : 1;
        const int64_t spill_cap = sg > 0 ? needed_len[0] : 0;
        std::atomic<int64_t> spill{0};
        parallel_ranges(rec, nthreads, [&](int64_t lo, int64_t hi, int) {
            for (int64_t i = lo; i < hi; ++i) {
                const uint8_t* r = buf + offs[i] + 4;
                int32_t tid, pos;
                uint16_t fl, nc;
                memcpy(&tid, r, 4);
                memcpy(&pos, r + 4, 4);
                memcpy(&nc, r + 12, 2);
                memcpy(&fl, r + 14, 2);
                if ((fl & flag_mask) != 0 || tid < 0 || tid >= n_refs)
                    continue;
                uint8_t l_read_name = r[8];
                const uint8_t* cg = r + 32 + l_read_name;
                int32_t* d = delta_ptrs[tid];
                const int64_t lim = d ? cur_lens[tid] : 0;
                int64_t ref = pos, runs = 0;
                for (int k = 0; k < nc; ++k) {
                    uint32_t c;
                    memcpy(&c, cg + 4 * k, 4);
                    uint32_t op = c & 0xF, ln = c >> 4;
                    if (op == 0) {
                        if (ref >= 0 && ref + (int64_t)ln < lim) {
                            __atomic_fetch_add(&d[ref], sg, __ATOMIC_RELAXED);
                            __atomic_fetch_add(&d[ref + ln], -sg,
                                               __ATOMIC_RELAXED);
                        } else if (sg > 0) {
                            int64_t s = spill.fetch_add(1);
                            if (s < spill_cap) {
                                needed_len[1 + 3 * s] = tid;
                                needed_len[2 + 3 * s] = ref;
                                needed_len[3 + 3 * s] = ln;
                            }
                        }
                        ++runs;
                        ref += ln;
                    } else if (op == 2 || op == 3) {
                        ref += ln;
                    }
                }
                if (runs)
                    __atomic_fetch_add(&ev_counts[tid], sg * runs,
                                       __ATOMIC_RELAXED);
            }
        });
        if (sg > 0) {
            int64_t s = spill.load();
            needed_len[0] = s;
            if (s > spill_cap) return -3;
        }
        if (!rec) return 0;
        uint32_t last_bs;
        memcpy(&last_bs, buf + offs[rec - 1], 4);
        return offs[rec - 1] + 4 + (int64_t)last_bs;
    }

    // pass B: per-tid required lengths (max M-run end + 1), no writes.
    // A run starting below position 0 (possible only in corrupt records)
    // cannot be represented densely — flagged and surfaced as -4 so the
    // caller falls back to the sparse event path.
    std::atomic<int> short_alloc{0};
    std::atomic<int> neg_start{0};
    parallel_ranges(rec, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* r = buf + offs[i] + 4;
            int32_t tid, pos;
            uint16_t fl, nc;
            memcpy(&tid, r, 4);
            memcpy(&pos, r + 4, 4);
            memcpy(&nc, r + 12, 2);
            memcpy(&fl, r + 14, 2);
            if ((fl & flag_mask) != 0 || tid < 0 || tid >= n_refs) continue;
            uint8_t l_read_name = r[8];
            const uint8_t* cg = r + 32 + l_read_name;
            int64_t ref = pos, max_end = pos;
            bool any = false;
            for (int k = 0; k < nc; ++k) {
                uint32_t c;
                memcpy(&c, cg + 4 * k, 4);
                uint32_t op = c & 0xF, ln = c >> 4;
                if (op == 0) {  // M: event [ref, ref+ln)
                    any = true;
                    if (ref < 0) neg_start.store(1, std::memory_order_relaxed);
                    if (ref + (int64_t)ln > max_end) max_end = ref + ln;
                    ref += ln;
                } else if (op == 2 || op == 3) {  // D/N advance
                    ref += ln;
                }
            }
            if (!any) continue;
            int64_t need = max_end + 1;
            int64_t seen = __atomic_load_n(&needed_len[tid], __ATOMIC_RELAXED);
            while (need > seen &&
                   !__atomic_compare_exchange_n(&needed_len[tid], &seen, need,
                                                false, __ATOMIC_RELAXED,
                                                __ATOMIC_RELAXED)) {
            }
            if (delta_ptrs[tid] == nullptr || cur_lens[tid] < need)
                short_alloc.store(1, std::memory_order_relaxed);
        }
    });
    if (neg_start.load()) return -4;
    if (short_alloc.load()) return -2;

    // pass C: atomic delta scatter + per-tid M-run counts
    parallel_ranges(rec, nthreads, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* r = buf + offs[i] + 4;
            int32_t tid, pos;
            uint16_t fl, nc;
            memcpy(&tid, r, 4);
            memcpy(&pos, r + 4, 4);
            memcpy(&nc, r + 12, 2);
            memcpy(&fl, r + 14, 2);
            if ((fl & flag_mask) != 0 || tid < 0 || tid >= n_refs) continue;
            uint8_t l_read_name = r[8];
            const uint8_t* cg = r + 32 + l_read_name;
            int32_t* d = delta_ptrs[tid];
            int64_t ref = pos, runs = 0;
            for (int k = 0; k < nc; ++k) {
                uint32_t c;
                memcpy(&c, cg + 4 * k, 4);
                uint32_t op = c & 0xF, ln = c >> 4;
                if (op == 0) {
                    __atomic_fetch_add(&d[ref], 1, __ATOMIC_RELAXED);
                    __atomic_fetch_add(&d[ref + ln], -1, __ATOMIC_RELAXED);
                    ++runs;
                    ref += ln;
                } else if (op == 2 || op == 3) {
                    ref += ln;
                }
            }
            if (runs)
                __atomic_fetch_add(&ev_counts[tid], runs, __ATOMIC_RELAXED);
        }
    });
    if (!rec) return 0;
    uint32_t last_bs;
    memcpy(&last_bs, buf + offs[rec - 1], 4);
    return offs[rec - 1] + 4 + (int64_t)last_bs;
}

// Dense delta array -> merged bedGraph rows + exact window bins, one pass.
// Emits "name\tstart\tend\tdepth\n" for every maximal constant-depth run
// with depth > 0 and accumulates depth*bp overlap into bins[w] for windows
// of size `window` (only w < n_windows; callers clamp exactly like
// ops/bamops.depth_window_bins). Returns bytes written to text, or -1 if
// cap could be exceeded (caller sizes cap from ev_counts: rows <=
// 2*ev_counts+1). L1 is the delta array length (>= last event end + 1).
// Dense delta array -> merged (start, end, depth) interval columns — the
// array form of ngs_depth_emit's bedGraph rows (maximal constant-depth
// runs with depth > 0; equals ops/bamops.merged_intervals on the same
// pileup). Feeds bam2wig's window binning, whose quirky inclusive-end
// arithmetic (reference bam2wig.c:130-175) lives in the vectorized
// wig_window_bins. Returns the row count, or -1 when cap is short
// (callers size cap >= 2*ev_count + 1). zero_after as in ngs_depth_emit.
int64_t ngs_depth_intervals(int32_t* delta, int64_t L1,
                            int64_t* starts, int64_t* ends, int64_t* depths,
                            int64_t cap, int zero_after) {
    int64_t k = 0, depth = 0, i = 0;
    while (i < L1) {
        depth += delta[i];
        if (zero_after) delta[i] = 0;
        int64_t j = i + 1;
        while (j < L1 && delta[j] == 0) ++j;
        if (depth > 0) {
            if (k >= cap) return -1;
            starts[k] = i;
            ends[k] = j;
            depths[k] = depth;
            ++k;
        }
        i = j;
    }
    return k;
}

// zero_after != 0 restores every nonzero delta entry to 0 as it is read:
// the array comes back all-zero from the emit for free (it reads every
// entry anyway), so recycled dense buffers never need a bulk memset.
int64_t ngs_depth_emit(int32_t* delta, int64_t L1, const uint8_t* name,
                       int32_t name_len, int64_t window, double* bins,
                       int64_t n_windows, uint8_t* text, int64_t cap,
                       int zero_after) {
    uint8_t* o = text;
    uint8_t* const end = text + cap;
    int64_t depth = 0, i = 0;
    while (i < L1) {
        depth += delta[i];
        if (zero_after) delta[i] = 0;
        int64_t j = i + 1;
        while (j < L1 && delta[j] == 0) ++j;
        if (depth > 0) {
            if (o + name_len + 70 > end) return -1;
            memcpy(o, name, name_len);
            o += name_len;
            *o++ = '\t'; o = put_i64(o, i);
            *o++ = '\t'; o = put_i64(o, j);
            *o++ = '\t'; o = put_i64(o, depth);
            *o++ = '\n';
            if (window > 0 && bins) {
                for (int64_t w = i / window; w < n_windows; ++w) {
                    int64_t ws = w * window;
                    if (ws >= j) break;
                    int64_t lo = i > ws ? i : ws;
                    int64_t hi = j < ws + window ? j : ws + window;
                    bins[w] += (double)((hi - lo) * depth);
                }
            }
        }
        i = j;
    }
    return o - text;
}

}  // extern "C"
