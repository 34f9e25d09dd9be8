"""A persistent world of gloo ranks on the CPU for the port's mesh tests.

`World(size)` starts `size` worker processes (this file run as a script),
joins them in one gloo process group on a free localhost port, and keeps
them until `close()`. `run(job, *args)` sends every rank the name of a
function of tests/torch_mesh_jobs.py and its arguments and returns the
ranks' results in rank order (plain pickles both ways: torch's own
reductions would share tensors through file descriptors); an exception on any rank fails the call with
that rank's traceback, and a rank that does not answer within the timeout
has every rank print its Python stack, closes the world and fails the call, so a hang costs one test, not the run.
The workers import neither JAX nor the JAX package, pin torch to one
thread, and their process group has a timeout of its own.
"""

from __future__ import annotations

import os
import pickle
import secrets
import signal
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Client, Listener

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    def __init__(self, size: int, timeout: float = 120.0):
        self.size, self.timeout = size, timeout
        key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), authkey=key)
        self._listener._listener._socket.settimeout(timeout)
        host, port = self._listener.address
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        gloo_port = free_port()
        self._procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), host, str(port),
             key.hex(), str(r), str(size), str(gloo_port)],
            cwd=ROOT, env=env) for r in range(size)]
        conns = {}
        try:
            for _ in range(size):
                c = self._listener.accept()
                conns[c.recv()] = c
        except Exception:
            self.close()
            raise
        self._conns = [conns[r] for r in range(size)]

    def run(self, job: str, *args, **kwargs):
        msg = pickle.dumps((job, args, kwargs))
        for c in self._conns:
            c.send_bytes(msg)
        out = []
        for r, c in enumerate(self._conns):
            if not c.poll(self.timeout):
                # every rank's Python stack to its stderr, then stop
                for p in self._procs:
                    p.send_signal(signal.SIGUSR1)
                time.sleep(1.0)
                self.close()
                raise TimeoutError(f"rank {r} gave no result for {job} in "
                                   f"{self.timeout} s")
            out.append(pickle.loads(c.recv_bytes()))
        errors = [f"rank {r}:\n{v}" for r, (s, v) in enumerate(out)
                  if s != "ok"]
        if errors:
            raise AssertionError("\n".join(errors))
        return [v for _, v in out]

    def close(self):
        for c in getattr(self, "_conns", []):
            try:
                c.send_bytes(b"")
            except OSError:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._listener.close()


def _worker(host, port, key, rank, size, gloo_port):
    import datetime
    import faulthandler

    import torch

    faulthandler.register(signal.SIGUSR1)
    torch.set_num_threads(1)
    conn = Client((host, int(port)), authkey=bytes.fromhex(key))
    conn.send(int(rank))
    from face_recognition_models_tpu_torch.parallel import dist as pdist

    pdist.initialize(backend="gloo", device="cpu",
                     init_method=f"tcp://127.0.0.1:{gloo_port}",
                     rank=int(rank), world_size=int(size),
                     timeout=datetime.timedelta(seconds=120))
    import torch_mesh_jobs as jobs

    while True:
        try:
            msg = conn.recv_bytes()
        except EOFError:
            break
        if msg == b"":
            break
        job, args, kwargs = pickle.loads(msg)
        try:
            out = pickle.dumps(("ok", getattr(jobs, job)(*args, **kwargs)))
        except Exception:
            out = pickle.dumps(("error", traceback.format_exc()))
        conn.send_bytes(out)
    pdist.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    _worker(*sys.argv[1:])
