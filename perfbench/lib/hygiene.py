"""What a run leaves behind: processes, and modules it must not load."""

from __future__ import annotations

import contextlib
import os
import signal
import sys

# top-level names, compared whole: the port's own name begins with the JAX package's
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "orthogonalsphericalshellgrids_tpu")


def forbidden_loaded():
    """The forbidden top-level module names that this process has loaded."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def descendants():
    """(pid, command) of every process below this one, read from /proc."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                pass
    found, todo = [], [os.getpid()]
    while todo:
        kids = [c for c, pp in parent.items() if pp == todo[-1]]
        todo.pop()
        found += kids
        todo += kids
    out = []
    for pid in found:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                out.append((pid, f.read().replace(b"\0", b" ").decode(errors="replace")))
        except OSError:
            pass
    return out


def stop_processes():
    """Stop every process the run started and left: multiprocessing's resource
    tracker (which ``parallel.spawn``'s queue starts, and which otherwise outlives
    this process), then any other descendant, killed (named on stderr) and reaped."""
    import multiprocessing
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        tracker._stop()
    for p in multiprocessing.active_children():
        p.kill()
        p.join()
    left = descendants()
    for pid, cmd in left:
        print(f"perfbench: stopping a process left running: {pid} {cmd}", file=sys.stderr)
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    for pid, _ in left:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)
