"""Process helpers the port's CPU tests share: a file's independent
processes started at once, and a drill's ranks run beside the JAX side they
are held against.  Both cut a file's wall time, not its work."""
import concurrent.futures
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def module_argv(module, args):
    return [sys.executable, "-m", module, *args]


def run_at_once(runs, timeout=300):
    """Each ``(argv, env)`` of ``runs`` as a process from the repository's
    root, all at once; their ``CompletedProcess``-like results in order."""
    procs = [subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for argv, env in runs]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=timeout)
        out.append(subprocess.CompletedProcess(p.args, p.returncode, stdout,
                                               stderr))
    return out


def in_background(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` started on a thread of its own: its
    future."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(fn, *args, **kwargs)
    pool.shutdown(wait=False)
    return future
