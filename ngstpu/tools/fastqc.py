"""fastqc: FastQC-style QC report (the Rfastqc.R pipeline on the device).

Equivalent of `Rscript Rfastqc.R out fq1 [fq2]` (reference Rfastqc.R:356-384
driving Rgzfastq_uniq.c): computes the duplication counts, per-read GC,
128x300 quality matrix, 5x300 nucleotide matrix and length histogram on
device, then renders the report as TSV matrices plus PNG charts (per-cycle
quality heatmap with Q20/Q30 markers, nucleotide content, GC density,
length distribution, duplication levels). Plot files are our own rendering
(the reference's PNGs are R-device output and not a byte-parity surface);
the underlying matrices match Rgzfastq_uniq.c exactly.

Usage: ngstpu fastqc <out_prefix> <fq1> [fq2]
"""

from __future__ import annotations

import sys

import numpy as np
import jax.numpy as jnp

from ..io.fastq import read_fastq_file
from ..io.native import concat_pairs
from ..ops.fastqc import (ADAPTERS, KMER_K, MAX_LEN, adapter_content,
                          fastqc_stats, kmer_position_counts, kmer_report,
                          overrepresented, parse_tile_ids, per_tile_quality,
                          truncated_key)
from ..ops.sortengine import dedup_groups, pack_for_dedup
from ..utils.placement import placement as placement_rule
from ..utils.png import Canvas, write_png
from ..utils.timing import StageTimer

NT_ROWS = "TCAGN"
Q20, Q30 = 53, 63  # raw ascii thresholds (Rfastqc.R:240-244)


def mate_stats(batch, placement: str):
    from ..ops.fastqc import fastqc_stats_host, gc_fraction

    if placement == "host":
        st = fastqc_stats_host(batch.seq, batch.qual, batch.lens, batch.n)
    else:
        res = fastqc_stats(jnp.asarray(batch.seq), jnp.asarray(batch.qual),
                           jnp.asarray(batch.lens), jnp.int32(batch.n))
        st = {k: np.asarray(v) for k, v in res.items()}
    st["gc_frac"] = gc_fraction(st["gc_count"][:batch.n], batch.lens)
    return st


def dup_groups(b1, b2=None, placement: str = "device"):
    """Dedup over the truncated key; returns (counts, rep, key, key_lens)."""
    k1, l1 = truncated_key(b1.seq, b1.lens)
    if b2 is not None:
        k2, l2 = truncated_key(b2.seq, b2.lens)
        width = ((k1.shape[1] + k2.shape[1] + 3) // 4) * 4
        key = concat_pairs(k1, l1, k2, l2, width)
        key_lens = (l1.astype(np.int64) + l2.astype(np.int64)).astype(np.int32)
    else:
        key, key_lens = k1, l1
    if placement == "host":
        from ..ops.fastqc import dedup_groups_host_native

        counts, rep = dedup_groups_host_native(key, key_lens)
        return counts, rep, key, key_lens
    words, encode_len = pack_for_dedup(key)
    g = dedup_groups(words, jnp.asarray(key_lens),
                     jnp.zeros(len(key_lens), jnp.uint32), len(key_lens),
                     length_first=False, words_encode_len=encode_len)
    return g["counts"], g["rep"], key, key_lens


def _write_matrix(path: str, mat: np.ndarray, row_names=None,
                  col_offset: int = 1) -> None:
    with open(path, "w") as f:
        f.write("#" + "\t".join(str(c + col_offset)
                                for c in range(mat.shape[1])) + "\n")
        for r in range(mat.shape[0]):
            name = row_names[r] if row_names else str(r)
            f.write(name + "\t" + "\t".join(str(int(v)) for v in mat[r]) + "\n")


def _chart_lines(path: str, series: dict, width=900, height=360,
                 colors=None) -> None:
    canvas = Canvas(width, height)
    canvas.rectangle(40, 10, width - 10, height - 30, (0, 0, 0))
    palette = colors or [(70, 130, 180), (255, 140, 0), (107, 142, 35),
                         (178, 34, 34), (106, 90, 205)]
    vmax = max((float(np.max(v)) for v in series.values() if len(v)), default=1.0)
    vmax = vmax or 1.0
    for i, (name, vals) in enumerate(series.items()):
        color = palette[i % len(palette)]
        n = len(vals)
        if n < 2:
            continue
        xs = 40 + (np.arange(n) / (n - 1)) * (width - 55)
        ys = (height - 30) - (np.asarray(vals, float) / vmax) * (height - 45)
        for k in range(n - 1):
            _line(canvas, xs[k], ys[k], xs[k + 1], ys[k + 1], color)
        canvas.filled_rectangle(50 + i * 90, height - 25, 60 + i * 90,
                                height - 15, color)
        canvas.text(64 + i * 90, height - 27, name[:8], color, scale=1)
    write_png(path, canvas)


def _line(canvas, x1, y1, x2, y2, color) -> None:
    steps = int(max(abs(x2 - x1), abs(y2 - y1))) + 1
    for t in range(steps + 1):
        f = t / steps
        canvas.set_pixel(int(x1 + (x2 - x1) * f), int(y1 + (y2 - y1) * f), color)


def _kde(values: np.ndarray, n_grid: int):
    """Gaussian kernel density like R's density(): nrd0 bandwidth, grid
    spanning [min - 3bw, max + 3bw], binned convolution evaluation."""
    v = np.asarray(values, float)
    if len(v) == 0:
        return np.zeros(n_grid), np.zeros(n_grid)
    sd = float(v.std(ddof=1)) if len(v) > 1 else 0.0
    q75, q25 = np.percentile(v, [75, 25])
    iqr = float(q75 - q25)
    spread = min(sd, iqr / 1.34) if iqr > 0 else sd
    if spread <= 0:
        spread = abs(float(v.mean())) or 1.0
    bw = 0.9 * spread * len(v) ** (-0.2)
    lo, hi = float(v.min()) - 3 * bw, float(v.max()) + 3 * bw
    x = np.linspace(lo, hi, n_grid)
    # bin then convolve: exact enough at n_grid bins, O(n + grid^2/…)
    hist, edges = np.histogram(v, bins=n_grid, range=(lo, hi))
    centers = (edges[:-1] + edges[1:]) / 2
    y = np.zeros(n_grid)
    k = np.exp(-0.5 * ((x[:, None] - centers[None, :]) / bw) ** 2)
    y = (k @ hist) / (len(v) * bw * np.sqrt(2 * np.pi))
    return x, y


def _gc_density_chart(path: str, gc_pct: np.ndarray, n_grid: int) -> None:
    """GC kernel-density curve with the mean / max-density annotations of
    reference Rfastqc.R:120-156 plot_GC_density (dashed drop line at the
    density peak + legend with both percentages)."""
    width, height = 900, 600
    canvas = Canvas(width, height)
    canvas.rectangle(50, 20, width - 20, height - 40, (0, 0, 0))
    x, y = _kde(gc_pct, max(n_grid, 64))
    if y.max() <= 0:
        write_png(path, canvas)
        return
    steel = (70, 130, 180)
    xs = 50 + (x - x[0]) / max(x[-1] - x[0], 1e-9) * (width - 70)
    ys = (height - 40) - y / y.max() * (height - 80)
    for k in range(len(x) - 1):
        _line(canvas, xs[k], ys[k], xs[k + 1], ys[k + 1], steel)
    # dashed segment from the peak down to the axis (R `segments(...lty=2)`)
    pk = int(np.argmax(y))
    for yy in range(int(ys[pk]), height - 40, 6):
        canvas.filled_rectangle(int(xs[pk]), yy, int(xs[pk]),
                                min(yy + 3, height - 40), (0, 0, 0))
    mean_gc = float(np.mean(gc_pct)) if len(gc_pct) else 0.0
    canvas.text(width - 340, 30, f"Mean GC%: {mean_gc:.2f}%", (0, 0, 0),
                scale=2)
    canvas.text(width - 340, 50, f"Max density GC%: {x[pk]:.2f}%", (0, 0, 0),
                scale=2)
    canvas.text(width // 2 - 30, height - 20, "GC(%)", (0, 0, 0), scale=2)
    write_png(path, canvas)


def _boxplot_chart(path: str, qmat: np.ndarray, n_cycles: int) -> None:
    """Per-cycle quality boxplot (Rfastqc.R:235-267 plot_boxplot): scores
    34..75, Tukey box (quartiles + median), 1.5-IQR whiskers, no
    outliers; Q20/Q30 guide lines. Computed from the quality histogram
    (weighted quantiles — the R script downsamples counts by 100 before
    replicating, which empties small files; we use the full counts)."""
    width, height = 900, 600
    canvas = Canvas(width, height)
    canvas.rectangle(50, 20, width - 20, height - 40, (0, 0, 0))
    scores = np.arange(34, 76)
    sub = qmat[34:76, :n_cycles].astype(np.float64)  # [42, cycles]
    n_cycles = sub.shape[1]
    if n_cycles == 0:
        write_png(path, canvas)
        return

    def y_of(score):
        return int((height - 40) - (score - 34) / (75 - 34) * (height - 80))

    steel = (70, 130, 180)
    span = (width - 80) / max(n_cycles, 1)
    bw2 = max(int(span * 0.75 / 2), 1)
    for c in range(n_cycles):
        col = sub[:, c]
        tot = col.sum()
        if tot == 0:
            continue
        cum = np.cumsum(col)

        def wq(p):
            return float(scores[np.searchsorted(cum, p * tot)])

        q1, med, q3 = wq(0.25), wq(0.5), wq(0.75)
        iqr = q3 - q1
        lo_lim, hi_lim = q1 - 1.5 * iqr, q3 + 1.5 * iqr
        present = scores[col > 0]
        wlo = float(present[present >= lo_lim].min())
        whi = float(present[present <= hi_lim].max())
        xc = int(50 + (c + 0.5) * span)
        canvas.filled_rectangle(max(xc - bw2, 50), y_of(q3),
                                min(xc + bw2, width - 21), y_of(q1), steel)
        canvas.filled_rectangle(max(xc - bw2, 50), y_of(med),
                                min(xc + bw2, width - 21), y_of(med),
                                (0, 0, 0))
        for a, b_ in ((whi, q3), (q1, wlo)):
            canvas.filled_rectangle(xc, y_of(a), xc, y_of(b_), (0, 0, 0))
    for score, color in ((53, (255, 140, 0)), (63, (178, 34, 34))):
        yline = y_of(score)
        canvas.filled_rectangle(50, yline, width - 21, yline, color)
    canvas.text(width // 2 - 30, height - 20, "CYCLE", (0, 0, 0), scale=2)
    write_png(path, canvas)


def _heatmap(path: str, mat: np.ndarray, q20_row: int, q30_row: int) -> None:
    """Quality heatmap: rows=qual value (33..104), cols=cycle."""
    sub = mat[33:105, :]  # visible phred range
    h, w = sub.shape
    scale_x, scale_y = 3, 4
    canvas = Canvas(w * scale_x + 60, h * scale_y + 40)
    vmax = float(sub.max()) or 1.0
    norm = (sub.astype(float) / vmax * 255).astype(np.uint8)
    for r in range(h):
        for c in range(w):
            v = int(norm[h - 1 - r, c])
            if v:
                canvas.filled_rectangle(40 + c * scale_x, 20 + r * scale_y,
                                        40 + c * scale_x + scale_x - 1,
                                        20 + r * scale_y + scale_y - 1,
                                        (255 - v, 255 - v, 255))
    for row, color in ((q20_row, (255, 140, 0)), (q30_row, (178, 34, 34))):
        y = 20 + (h - 1 - (row - 33)) * scale_y
        canvas.filled_rectangle(40, y, 40 + w * scale_x, y, color)
    write_png(path, canvas)


def run(out_prefix: str, fq1: str, fq2: str | None) -> None:
    timer = StageTimer()
    b1 = read_fastq_file(fq1)
    b2 = read_fastq_file(fq2) if fq2 else None
    mates = [(1, b1)] + ([(2, b2)] if b2 is not None else [])

    placement = placement_rule()
    for idx, b in mates:
        st = mate_stats(b, placement)
        L = min(st["quality"].shape[0], MAX_LEN)
        qmat = np.zeros((128, MAX_LEN), dtype=np.int64)
        qmat[:, :L] = st["quality"][:L, :].T
        nmat = np.zeros((5, MAX_LEN), dtype=np.int64)
        nmat[:, :L] = st["ntval"][:L, :].T
        _write_matrix(f"{out_prefix}_quality_mate{idx}.tsv", qmat)
        _write_matrix(f"{out_prefix}_nucleotide_mate{idx}.tsv", nmat,
                      row_names=list(NT_ROWS))
        with open(f"{out_prefix}_length_mate{idx}.tsv", "w") as f:
            for i, v in enumerate(st["len_hist"]):
                if v:
                    f.write(f"{i + 1}\t{int(v)}\n")
        gc_hist, _ = np.histogram(st["gc_frac"][:b.n], bins=100, range=(0, 1))
        with open(f"{out_prefix}_gc_mate{idx}.tsv", "w") as f:
            f.write(f"#mean_gc\t{float(st['gc_frac'][:b.n].mean()) * 100:.6f}\n")
            for i, v in enumerate(gc_hist):
                f.write(f"{i / 100:.2f}\t{int(v)}\n")

        # charts
        per_cycle = st["quality"][:L, :]
        tot = per_cycle.sum(axis=1)
        q20 = per_cycle[:, Q20:].sum(axis=1)
        q30 = per_cycle[:, Q30:].sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            _chart_lines(f"{out_prefix}_q20q30_mate{idx}.png",
                         {"Q20": np.where(tot > 0, q20 / np.maximum(tot, 1), 0),
                          "Q30": np.where(tot > 0, q30 / np.maximum(tot, 1), 0)})
        _heatmap(f"{out_prefix}_quality_heatmap_mate{idx}.png", qmat, Q20, Q30)
        _chart_lines(f"{out_prefix}_nucleotide_mate{idx}.png",
                     {NT_ROWS[r]: nmat[r, :L] for r in range(5)})
        _gc_density_chart(f"{out_prefix}_gc_density_mate{idx}.png",
                          st["gc_frac"][:b.n] * 100.0, L)
        _boxplot_chart(f"{out_prefix}_boxplotquality_mate{idx}.png", qmat, L)
        _chart_lines(f"{out_prefix}_length_mate{idx}.png",
                     {"len": st["len_hist"]})

        # adapter content (FastQC module; ngstpu extension over Rfastqc.R)
        ad = np.frombuffer(b"".join(a for _, a in ADAPTERS),
                           np.uint8).reshape(len(ADAPTERS), -1)
        if placement == "host":
            from ..ops.fastqc import adapter_content_host

            ac = adapter_content_host(b.seq, b.lens, b.n, ad)
        else:
            ac = np.asarray(adapter_content(jnp.asarray(b.seq),
                                            jnp.asarray(b.lens),
                                            jnp.int32(b.n), jnp.asarray(ad)))
        Lb = b.seq.shape[1]
        with open(f"{out_prefix}_adapter_mate{idx}.tsv", "w") as f:
            f.write("#cycle\t" + "\t".join(n for n, _ in ADAPTERS) + "\n")
            for i in range(Lb):
                f.write(f"{i + 1}\t" + "\t".join(
                    f"{ac[a, i] * 100.0 / max(b.n, 1):.4f}"
                    for a in range(len(ADAPTERS))) + "\n")
        _chart_lines(f"{out_prefix}_adapter_mate{idx}.png",
                     {name.split()[0] + str(a): ac[a]
                      for a, (name, _) in enumerate(ADAPTERS)})

        # per-base N content (FastQC module): N row of the nt matrix
        with open(f"{out_prefix}_ncontent_mate{idx}.tsv", "w") as f:
            f.write("#cycle\tn_pct\n")
            col_tot = nmat.sum(axis=0)
            for i in range(L):
                if col_tot[i]:
                    f.write(f"{i + 1}\t"
                            f"{nmat[4, i] * 100.0 / col_tot[i]:.4f}\n")

        # per-tile quality (FastQC module; sampled like FastQC when big)
        step = 10 if b.n >= 20000 else 1
        parsed = parse_tile_ids(b, step=step)
        if parsed is not None:
            rows_idx, tile_ord, tiles = parsed
            if placement == "host":
                from ..ops.fastqc import per_tile_quality_host

                sums, cnts = per_tile_quality_host(
                    b.qual[rows_idx], b.lens[rows_idx], len(rows_idx),
                    tile_ord, len(tiles))
            else:
                sums, cnts = per_tile_quality(
                    jnp.asarray(b.qual[rows_idx]),
                    jnp.asarray(b.lens[rows_idx]),
                    jnp.int32(len(rows_idx)), jnp.asarray(tile_ord),
                    len(tiles))
            sums, cnts = np.asarray(sums, np.int64), np.asarray(cnts, np.int64)
            with np.errstate(invalid="ignore", divide="ignore"):
                tile_mean = np.where(cnts > 0, sums / np.maximum(cnts, 1), 0.0)
                g_cnt = cnts.sum(axis=0)
                g_mean = np.where(g_cnt > 0,
                                  sums.sum(axis=0) / np.maximum(g_cnt, 1), 0.0)
            dev = np.where(cnts > 0, tile_mean - g_mean[None, :], 0.0)
            with open(f"{out_prefix}_per_tile_mate{idx}.tsv", "w") as f:
                f.write("#tile\\cycle\t" + "\t".join(
                    str(c + 1) for c in range(dev.shape[1])) + "\n")
                for t, tile in enumerate(tiles):
                    f.write(f"{tile}\t" + "\t".join(
                        f"{dev[t, c]:.3f}" for c in range(dev.shape[1]))
                        + "\n")

        # kmer enrichment (FastQC module; every 50th read like FastQC)
        kstep = 50 if b.n >= 5000 else 1
        krows = np.arange(0, b.n, kstep, dtype=np.int64)
        if placement == "host":
            from ..ops.fastqc import kmer_position_counts_host

            kc = kmer_position_counts_host(b.seq[krows], b.lens[krows],
                                           len(krows))
        else:
            kc = np.asarray(kmer_position_counts(
                jnp.asarray(b.seq[krows]), jnp.asarray(b.lens[krows]),
                jnp.int32(len(krows))))
        with open(f"{out_prefix}_kmer_mate{idx}.tsv", "w") as f:
            f.write("#kmer\tcount\tmax_obs_exp\tposition\n")
            for km, cnt, ratio, pos in kmer_report(kc, KMER_K):
                f.write(f"{km}\t{cnt}\t{ratio:.3f}\t{pos}\n")

    counts, rep, key, key_lens = dup_groups(b1, b2, placement)
    dups = np.sort(counts)[::-1]
    levels = np.bincount(np.minimum(dups, 100))
    with open(f"{out_prefix}_duplication.tsv", "w") as f:
        uniq_pct = (len(dups) / b1.n * 100) if b1.n else 0.0
        f.write(f"#unique_reads\t{len(dups)}\t{uniq_pct:.3f}%\n")
        for lvl in range(1, len(levels)):
            if levels[lvl]:
                f.write(f"{lvl}\t{int(levels[lvl])}\n")
    _chart_lines(f"{out_prefix}_duplication.png", {"dup": levels[1:]})

    # overrepresented sequences (FastQC module; >0.1% of reads)
    rows = overrepresented(key, key_lens, counts, rep, b1.n)
    with open(f"{out_prefix}_overrepresented.tsv", "w") as f:
        f.write("#sequence\tcount\tpercentage\n")
        for s_, c, pct in rows:
            f.write(f"{s_.decode('latin-1')}\t{c}\t{pct:.4f}\n")
    timer.log("Finished at %.3f s\n")


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        sys.stderr.write("Usage: ngstpu fastqc <out_prefix> <fq1> [fq2]\n")
        return 1
    run(argv[0], argv[1], argv[2] if len(argv) > 2 else None)
    return 0
