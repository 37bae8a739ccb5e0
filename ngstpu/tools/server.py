"""Warm-process server: run tools without paying JAX start-up per call.

Starting a JAX client and compiling the device programs (the LSD sort
chains) is paid by every fresh process; production pipelines invoke tools
thousands of times. `ngstpu serve` keeps one warm process holding the
device client and every compiled program; subsequent CLI invocations
with NGSTPU_SERVER set (or `ngstpu client ...`) route over a unix socket
and reuse the warm state — a tool that cold-starts in seconds answers in
milliseconds-to-seconds warm.

Protocol: one JSON line request {"tool", "argv", "cwd"} -> one JSON line
response {"rc", "stdout" (base64), "stderr" (base64)}. Requests are
handled sequentially (tools are process-global: cwd, devices).
"""

from __future__ import annotations

import base64
import io
import json
import os
import socket
import socketserver
import sys

DEFAULT_SOCKET = "/tmp/ngstpu.sock"


class _FakeStdout(io.TextIOWrapper):
    pass


def _run_tool(tool: str, argv: list[str], cwd: str) -> tuple[int, bytes, bytes]:
    from .cli import TOOLS
    import importlib

    if tool not in TOOLS:
        return 2, b"", f"ngstpu: unknown tool '{tool}'\n".encode()
    out_buf, err_buf = io.BytesIO(), io.BytesIO()
    out_txt = io.TextIOWrapper(out_buf, encoding="utf-8", write_through=True)
    err_txt = io.TextIOWrapper(err_buf, encoding="utf-8", write_through=True)
    old_out, old_err, old_cwd = sys.stdout, sys.stderr, os.getcwd()
    sys.stdout, sys.stderr = out_txt, err_txt
    try:
        os.chdir(cwd)
        mod = importlib.import_module(TOOLS[tool])
        rc = mod.main(list(argv)) or 0
    except SystemExit as e:
        rc = int(e.code or 0)
    except Exception as e:  # tool errors must not kill the server
        err_txt.write(f"ngstpu {tool}: {type(e).__name__}: {e}\n")
        rc = 1
    finally:
        try:
            out_txt.flush()
            err_txt.flush()
        except ValueError:
            pass
        sys.stdout, sys.stderr = old_out, old_err
        os.chdir(old_cwd)
    return rc, out_buf.getvalue(), err_buf.getvalue()


def serve(sock_path: str = DEFAULT_SOCKET) -> None:
    from ..utils.jaxsetup import setup_jax_cache

    setup_jax_cache()
    if os.path.exists(sock_path):
        os.unlink(sock_path)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            line = self.rfile.readline()
            if not line:
                return
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                return
            if req.get("op") == "ping":
                self.wfile.write(b'{"rc": 0}\n')
                return
            if req.get("op") == "shutdown":
                self.wfile.write(b'{"rc": 0}\n')
                import threading

                threading.Thread(target=srv.shutdown, daemon=True).start()
                return
            rc, out, err = _run_tool(req.get("tool", ""), req.get("argv", []),
                                     req.get("cwd", os.getcwd()))
            self.wfile.write(json.dumps({
                "rc": rc,
                "stdout": base64.b64encode(out).decode(),
                "stderr": base64.b64encode(err).decode(),
            }).encode() + b"\n")

    srv = socketserver.UnixStreamServer(sock_path, Handler)
    sys.stderr.write(f"ngstpu server listening on {sock_path}\n")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        if os.path.exists(sock_path):
            os.unlink(sock_path)


def call_server(sock_path: str, tool: str, argv: list[str],
                timeout: float = 3600.0) -> int | None:
    """Route one tool invocation through a running server.
    Returns the exit code, or None if the server is unreachable."""
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(sock_path)
        f = s.makefile("rwb")
        f.write(json.dumps({"tool": tool, "argv": argv,
                            "cwd": os.getcwd()}).encode() + b"\n")
        f.flush()
        resp = f.readline()
        s.close()
    except OSError:
        return None
    if not resp:
        return None
    r = json.loads(resp)
    sys.stdout.buffer.write(base64.b64decode(r.get("stdout", "")))
    sys.stdout.buffer.flush()
    sys.stderr.buffer.write(base64.b64decode(r.get("stderr", "")))
    sys.stderr.buffer.flush()
    return int(r["rc"])


def main(argv: list[str]) -> int:
    sock = DEFAULT_SOCKET
    it = iter(argv)
    for a in it:
        if a == "--socket":
            sock = next(it, DEFAULT_SOCKET)
        elif a in ("-h", "--help"):
            sys.stderr.write("Usage: ngstpu serve [--socket PATH]\n")
            return 1
    serve(sock)
    return 0
