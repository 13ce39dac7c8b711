"""Device meshes over a ``torch.distributed`` world, and local worlds.

The port runs one process per rank (SPMD), each calling the same program.
Each process calls :func:`init_world`: a world of 1 from an in-process
store needs no launcher and no port; a wider world comes from
:func:`spawn_world`, which starts ``world`` local processes of one command
with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``REPRO_INIT_METHOD`` in
their environment (a ``file://`` store, so that no TCP port is taken), or
from ``torchrun`` (``env://``).  Then :func:`make_host_mesh` builds the
``("data", "model")`` mesh.

The JAX package's ``make_production_mesh`` (the TPU v5e shapes (16, 16)
and (2, 16, 16)) arrives with the dry run, its only user; the v5e
constants beside it are the TPU's and are not carried.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def init_world(backend: Optional[str] = None) -> str:
    """Join (or make) the default process group; returns its backend.

    With ``WORLD_SIZE`` unset (or 1, without ``REPRO_INIT_METHOD``) a
    world of 1 from an in-process ``HashStore``.  Otherwise rank and size
    from ``RANK``/``WORLD_SIZE`` and the store from ``REPRO_INIT_METHOD``
    (as :func:`spawn_world` sets it), else ``env://`` (``torchrun``).  The
    backend defaults to NCCL where a card is present and gloo otherwise
    (``"cuda:nccl,cpu:gloo"`` serves both kinds of tensor); under NCCL
    each rank takes the card of its ``LOCAL_RANK``."""
    if dist.is_initialized():
        return dist.get_backend()
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    method = os.environ.get("REPRO_INIT_METHOD")
    if "nccl" in backend:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if world == 1 and method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=method or "env://",
                                rank=int(os.environ["RANK"]),
                                world_size=world)
    return backend


def make_host_mesh(data: int = 1, model: int = 1,
                   device: Optional[str] = None):
    """A ``("data", "model")`` mesh over the whole initialized world, for
    tensors on ``device``: by default ``cuda`` where the backend has NCCL
    and ``cpu`` otherwise."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs a world of "
                         f"{data * model}, not {world}")
    device = device or ("cuda" if "nccl" in dist.get_backend() else "cpu")
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


def spawn_world(argv: Sequence[str], world: int, *, timeout: float = 600.0,
                env: Optional[dict] = None, store_dir: Optional[str] = None
                ) -> List[subprocess.CompletedProcess]:
    """Run ``argv`` as ``world`` local processes of one world (ranks 0 to
    world - 1) and wait for all of them; returns each rank's completed
    process (stdout and stderr captured as text).  If a rank fails or the
    time runs out, the others are killed and a ``RuntimeError`` carries
    every rank's output."""
    own = store_dir is None
    store_dir = store_dir or tempfile.mkdtemp(prefix="repro_world_")
    store = os.path.join(store_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    procs, files = [], []
    try:
        for rank in range(world):
            e = dict(os.environ if env is None else env, RANK=str(rank),
                     WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                     REPRO_INIT_METHOD=f"file://{store}")
            out = tempfile.TemporaryFile("w+")
            err = tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen(list(argv), env=e, stdout=out,
                                          stderr=err, text=True))
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = "timed out"
                break
            if any(p.returncode not in (None, 0) for p in procs):
                failed = "a rank failed"
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        done = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            done.append(subprocess.CompletedProcess(
                p.args, p.returncode, out.read(), err.read()))
        if failed or any(d.returncode != 0 for d in done):
            raise RuntimeError(
                f"world of {world} {failed or 'failed'}:\n" + "\n".join(
                    f"--- rank {r} (exit {d.returncode})\n{d.stdout}\n"
                    f"{d.stderr[-4000:]}" for r, d in enumerate(done)))
        return done
    finally:
        for out, err in files:
            out.close()
            err.close()
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)

