"""Multi-process dry run on the CPU: gloo ranks standing in for cards.

The gloo twin of ``dryrun_multichip`` in the repo root's ``__graft_entry__.py``
(which runs the JAX package on n virtual devices). :func:`dryrun_multichip`
spawns n CPU processes, one torch thread each, joined in a (model, data)
mesh with ``model`` 2 when n is even, and runs three parts:

1. the dp x tp CLIP contrastive train step at the ``"test"`` preset;
2. a small Grounding-DINO (a four-stage Swin pyramid, four feature levels
   at 256 x 320) with its Linears tensor-parallel and the frames over
   ``data``;
3. the frame-sharded lift at ScanNet scale: 250 000 points, 32 frames of
   120 x 160, 8 masks a frame.

:func:`launch` is the process harness: a ``file://`` rendezvous in a
directory of the caller's, a 60 s timeout on the group, and a deadline
after which every child still running is killed.

    python -m beyondff_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

GROUP_TIMEOUT_S = 60.0


def _child(fn, rank, n, init, args, threads, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out.put((rank, True, fn(rank, n, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, n: int, args: Sequence = (), workdir: Optional[str] = None,
           timeout: float = 180.0, threads: int = 1) -> List:
    """Run ``fn(rank, n, *args)`` in ``n`` spawned processes joined in one
    gloo group; returns the results by rank. ``fn`` and ``args`` must
    pickle (a module-level function). Raises with the first failing rank's
    traceback, or ``TimeoutError`` at ``timeout`` seconds; either way every
    child still running is killed."""
    import multiprocessing as mp

    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="bff_dist_") if own else workdir
    name = f"rendezvous_{os.getpid()}_{time.time_ns()}"
    init = "file://" + os.path.join(os.path.abspath(workdir), name)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, n, init, tuple(args), threads, out),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results, failure = {}, None
    try:
        while len(results) < n and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n - len(results)} of {n} ranks unfinished after {timeout} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results and p.exitcode]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                continue
            if ok:
                results[rank] = payload
            else:
                failure = f"rank {rank} failed:\n{payload}"
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(5.0, deadline - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(n)]


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def small_gdino_config():
    """``__graft_entry__.py``'s small Grounding-DINO: a real four-stage Swin
    pyramid and four feature levels at a (256, 320) input (1 280 level-0
    queries)."""
    from beyondff_tpu_torch.models.gdino import bert as bert_mod
    from beyondff_tpu_torch.models.gdino import model as gdino_model
    from beyondff_tpu_torch.models.gdino import swin as swin_mod

    return gdino_model.GDINOConfig(
        swin=swin_mod.SwinConfig(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(2, 2, 4, 4),
                                 window_size=6, out_indices=(1, 2, 3)),
        bert=bert_mod.BertConfig(vocab_size=512, hidden=64, layers=2, heads=2,
                                 intermediate=128, max_position=64),
        hidden=64, heads=4, levels=4, enc_layers=2, dec_layers=2, ffn_dim=256,
        num_queries=128, max_text_len=16, image_size=(256, 320))


def _dryrun_worker(rank: int, n: int) -> dict:
    import numpy as np
    import torch

    from beyondff_tpu_torch.core import geometry
    from beyondff_tpu_torch.models import clip as clip_mod
    from beyondff_tpu_torch.models import layers
    from beyondff_tpu_torch.models.gdino import model as gdino_model
    from beyondff_tpu_torch.parallel import lift as lift_lib
    from beyondff_tpu_torch.parallel import mesh as mesh_lib
    from beyondff_tpu_torch.training.trainer import local_batch, make_sharded_train_step

    cpu = torch.device("cpu")
    model_par = 2 if n % 2 == 0 else 1
    mesh = mesh_lib.make_mesh(data=-1, model=model_par, device_type="cpu")
    data_par = n // model_par
    rng = np.random.default_rng(0)

    # ---- 1. dp x tp training step (CLIP contrastive)
    c = clip_mod.PRESETS["test"]
    clip = layers.build(lambda: clip_mod.CLIPModule(c), cpu, seed=0)
    init_state, train_step = make_sharded_train_step(clip, mesh)
    state = init_state()
    batch = max(data_par, 2)
    images = torch.from_numpy(rng.normal(size=(batch, c.image_resolution, c.image_resolution, 3))
                              .astype(np.float32))
    tokens = torch.from_numpy(rng.integers(1, c.vocab_size, (batch, c.context_length)))
    state, loss = train_step(state, images, tokens)
    loss = float(loss)
    _check(np.isfinite(loss), f"non-finite loss {loss}")
    _check(state.step == 1, "step count")

    # ---- 2. detection: frames over `data`, Linears over `model`
    cfg = small_gdino_config()
    gdino = mesh_lib.shard_params(layers.build(lambda: gdino_model.GDINOModule(cfg), cpu, seed=0),
                                  mesh)
    gh, gw = cfg.image_size
    t = 8
    g_img = torch.from_numpy(rng.normal(size=(data_par, gh, gw, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(1, cfg.bert.vocab_size, (data_par, t)))
    text = (torch.ones(data_par, t, t, dtype=torch.bool), torch.ones(data_par, t, dtype=torch.bool),
            torch.zeros(data_par, t, dtype=torch.long))
    g_img, ids, *text = local_batch(mesh, (g_img, ids, *text))
    with torch.no_grad():
        logits, boxes = gdino(g_img, ids, *text)
    scores = torch.sigmoid(logits.float()).amax(dim=-1)
    _check(bool(torch.isfinite(scores).all()), "non-finite detection scores")
    _check(tuple(boxes.shape) == (g_img.shape[0], cfg.num_queries, 4), f"boxes {boxes.shape}")

    # ---- 3. projection lift: frames over `data`, counts summed, at
    # ScanNet scale (250k points, 32 frames, quarter-resolution depth)
    lift = lift_lib.make_sharded_lift(mesh)
    n_pts, n_frames, hh, ww, n_masks = 250_000, 32, 120, 160, 8
    pcd_h = torch.from_numpy(geometry.homogenize(
        rng.uniform([-2, -2, 0.5], [2, 2, 4], (n_pts, 3)).astype(np.float32)))
    intr = np.array([[140.0, 0, ww / 2], [0, 140.0, hh / 2], [0, 0, 1.0]])
    projs = torch.from_numpy(np.stack([geometry.fuse_projection(intr, np.eye(4))
                                       .astype(np.float32)] * n_frames))
    depths = torch.from_numpy(rng.uniform(0.5, 3.0, (n_frames, hh, ww)).astype(np.float32))
    masks = torch.from_numpy(rng.random((n_frames, n_masks, hh * ww)) > 0.5)
    valid = torch.ones(n_frames, n_masks, dtype=torch.bool)
    membership, masked_counts, viewed_counts = lift(pcd_h, projs, depths, masks, valid)
    _check(tuple(membership.shape) == (n_frames // data_par, n_masks, n_pts),
           f"membership {tuple(membership.shape)}")
    _check(tuple(masked_counts.shape) == (n_pts,), "masked_counts shape")
    total = int(viewed_counts.sum())
    _check(total > 0, "no point viewed")
    return {"mesh": [model_par, data_par], "loss": loss,
            "gdino_max_score": float(scores.max()), "lift_viewed": total}


def dryrun_multichip(n_devices: int, workdir: Optional[str] = None,
                     timeout: float = 300.0) -> dict:
    """The three parts on ``n_devices`` gloo ranks; returns rank 0's summary
    (mesh shape, loss, top detection score, summed views) after checking
    every rank's."""
    results = launch(_dryrun_worker, n_devices, workdir=workdir, timeout=timeout)
    first = results[0]
    _check(all(r["lift_viewed"] == first["lift_viewed"] and r["loss"] == first["loss"]
               for r in results), f"ranks disagree: {results}")
    m, d = first["mesh"]
    print(f"dryrun_multichip: mesh=({m}x{d}) loss={first['loss']:.4f} "
          f"gdino_max_score={first['gdino_max_score']:.4f} "
          f"lift_viewed={first['lift_viewed']} OK", flush=True)
    return first


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
