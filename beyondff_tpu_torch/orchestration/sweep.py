"""Class-sweep orchestrator: the pipeline's outermost driver.

The port of beyondff_tpu/orchestration/sweep.py, rebuilding the reference's
subprocess loop (reference: evaluation/eval/run_evl.py:56-118): for each
class in head[:40] + common[:40] + tail[:40] minus a skip list, run
segmentation_2d -> projection -> refinement -> evaluation, persisting
per-(class, stage) completion to a YAML checkpoint so interrupted multi-day
sweeps resume exactly.

Stages run in-process (the models stay resident on the card across
classes), or with ``use_subprocess=True`` as the port's own CLIs
(``python -m beyondff_tpu_torch.tools.<stage>``) for crash isolation.
Failures are caught per stage so the sweep continues (run_evl.py:115-118);
the amortized multi-class passes fall back to the per-class stages, as in
the JAX package, and :attr:`SweepRunner.amortized` records which classes
each amortized pass completed.

Multi-host: ``SweepRunner(hosts=N, host=i)`` takes the deterministic
interleaved partition ``classes[i::N]``, writes per-host checkpoints and
per-host results tables, and :func:`merge_host_results` folds them into the
canonical ``overall_results.txt``, byte-identical to a single-host run.
Against the JAX package, three faults stay out (ADVICE.md): an explicit
``host`` without ``hosts`` raises instead of running every class; with
``use_subprocess`` the evaluation CLI gets the per-host table; and
:func:`merge_host_results` raises when no per-host table exists instead of
writing a blank template over the canonical one.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.data import scannet200
from beyondff_tpu_torch.utils.checkpoint import SweepCheckpoint

# classes the reference skips as known-bad (run_evl.py:105)
DEFAULT_SKIP = ("ceiling light", "office chair")
# the directory that holds the package, for the stage CLIs' import path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CLI = {"segmentation": "segmentation_2d", "projection": "projection_2d_to_3d",
        "refinement": "refinement", "evaluation": "eval_scannet200"}


def default_class_list(per_group: int = 40) -> List[str]:
    """head[:N] + common[:N] + tail[:N] (reference: run_evl.py:103)."""
    return (list(scannet200.HEAD_CATS_SCANNET_200[:per_group])
            + list(scannet200.COMMON_CATS_SCANNET_200[:per_group])
            + list(scannet200.TAIL_CATS_SCANNET_200[:per_group]))


def host_partition(classes: Sequence[str], hosts: int, host: int) -> List[str]:
    """Deterministic interleaved class partition: host ``i`` of ``N`` takes
    ``classes[i::N]``, which balances the head/common/tail mix across hosts
    with no coordination."""
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    if not 0 <= host < hosts:
        raise ValueError(f"host index {host} out of range for {hosts} hosts")
    return list(classes)[host::hosts]


def host_suffix(hosts: int, host: int) -> str:
    return f".host{host}of{hosts}" if hosts > 1 else ""


def resolve_hosts(hosts=None, host=None) -> tuple:
    """(hosts, host) from explicit arguments, else from an initialized
    ``torch.distributed`` group of several processes, else single-host. A
    ``host`` without ``hosts`` raises: it would otherwise run every class."""
    if hosts is not None:
        return int(hosts), int(host or 0)
    if host is not None:
        raise ValueError(f"host index {host} given without the number of hosts")
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def merge_host_results(cfg: Config, hosts: int,
                       checkpoint_path: str = "process_checkpoint.txt") -> None:
    """Fold per-host artifacts into the canonical single-host ones: the
    per-host results tables into ``overall_results.txt`` (byte-identical to
    a single-host run over the same classes) and the per-host sweep
    checkpoints into the canonical checkpoint (a class marked by any host
    keeps its flags). Raises ``FileNotFoundError`` when none of the per-host
    tables exists."""
    from beyondff_tpu_torch.pipeline.evaluate import merge_results_tables

    rd = cfg.paths.results_dir
    tables = [os.path.join(rd, f"overall_results{host_suffix(hosts, i)}.txt")
              for i in range(hosts)]
    if not any(os.path.exists(t) for t in tables):
        raise FileNotFoundError(f"no per-host results table to merge: {tables}")
    merge_results_tables(tables, os.path.join(rd, "overall_results.txt"))
    merged = SweepCheckpoint(checkpoint_path)
    for i in range(hosts):
        part = SweepCheckpoint(checkpoint_path + host_suffix(hosts, i))
        for class_name, stages in part._state.items():
            merged._state.setdefault(class_name, {}).update(stages)
    merged.flush()


class SweepRunner:
    """``device``: where the stages run (``cuda`` unless named);
    ``segmentor``: an injected :class:`Segmentor2D` (models built in code);
    ``plot_pr_curves``: the evaluation stage's PR-curve PNGs (matplotlib)."""

    STAGES = ("segmentation", "projection", "refinement", "evaluation")

    def __init__(self, cfg: Config, config_path: Optional[str] = None,
                 checkpoint_path: str = "process_checkpoint.txt",
                 skip_segmentation: bool = False, use_subprocess: bool = False,
                 retries: int = 0, amortize_projection: bool = True,
                 hosts: int = 1, host: int = 0, device=None, segmentor=None,
                 plot_pr_curves: bool = True):
        self.cfg = cfg
        self.config_path = config_path
        self.hosts, self.host = hosts, host
        if not 0 <= host < hosts:
            raise ValueError(f"host index {host} out of range for {hosts} hosts")
        suffix = host_suffix(hosts, host)
        self.table_name = f"overall_results{suffix}.txt"
        self.checkpoint = SweepCheckpoint(checkpoint_path + suffix)
        # reuse cached 2D masks and re-run only the cheap stages: the
        # reference's parameter-sweep mode (run_evl_finding_parameter.py:56-87)
        self.skip_segmentation = skip_segmentation
        self.use_subprocess = use_subprocess
        # per-stage retry budget (the reference gives up on the first error)
        self.retries = retries
        # scene-outer multi-class projection for classes whose 2D masks are
        # on disk: each scene's depth uploads once for every class
        self.amortize_projection = amortize_projection
        self.device = device
        self.plot_pr_curves = plot_pr_curves
        self._segmentor = segmentor
        # the classes each amortized pass completed
        self.amortized: Dict[str, List[str]] = {"segmentation": [], "projection": []}

    def _seg2d(self):
        from beyondff_tpu_torch.pipeline import segmentation_2d

        if self._segmentor is None:
            self._segmentor = segmentation_2d.Segmentor2D(self.cfg, device=self.device)
        return segmentation_2d, self._segmentor

    # scene-outer multi-class 2D stage (run(amortize_segmentation=True)):
    # frames load and upload once per scene for the whole class list, and
    # the detector's pyramids and SAM's embeddings are banked. Off by
    # default: it runs the heaviest stage for every class before any class
    # completes end to end.
    def _amortized_segmentation(self, classes: Sequence[str]) -> None:
        pending = [c for c in classes if not self.checkpoint.stage_done(c, "segmentation")]
        if len(pending) < 2:
            return
        seg2d, seg = self._seg2d()
        t0 = time.time()
        try:
            seg2d.run_classes(self.cfg, pending, segmentor=seg)
        except Exception:
            traceback.print_exc()
            print("[sweep] amortized segmentation failed; classes fall back to the "
                  "per-class stage")
            return
        for c in pending:
            self.checkpoint.mark(c, "segmentation", True)
        self.amortized["segmentation"].extend(pending)
        print(f"[sweep] amortized segmentation: {len(pending)} classes "
              f"({time.time() - t0:.1f}s)")

    # ------------------------------------------------------------- stages
    def _run_stage(self, stage: str, class_name: str) -> None:
        if self.use_subprocess:
            cmd = [sys.executable, "-m", f"beyondff_tpu_torch.tools.{_CLI[stage]}",
                   "--config", self.config_path, "--cls", class_name]
            if stage == "evaluation":
                cmd += ["--table", self.table_name]
                if not self.plot_pr_curves:
                    cmd.append("--no-pr-curves")
            elif self.device is not None:
                cmd += ["--device", str(self.device)]
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_ROOT, env.get("PYTHONPATH")) if p)
            subprocess.run(cmd, check=True, env=env)
            return
        if stage == "segmentation":
            seg2d, seg = self._seg2d()
            seg2d.run(self.cfg, class_name, segmentor=seg)
        elif stage == "projection":
            from beyondff_tpu_torch.pipeline import projection

            projection.run(self.cfg, class_name, device=self.device)
        elif stage == "refinement":
            from beyondff_tpu_torch.pipeline import refinement

            refinement.run(self.cfg, class_name, device=self.device)
        elif stage == "evaluation":
            from beyondff_tpu_torch.pipeline import evaluate

            evaluate.run(self.cfg, class_name, verbose=False, table_name=self.table_name,
                         plot_pr_curves=self.plot_pr_curves)

    def process_class(self, class_name: str) -> Dict[str, bool]:
        """All four stages for one class, with per-stage resume and failure
        tolerance (reference: run_evl.py:56-96)."""
        status: Dict[str, bool] = {}
        for stage in self.STAGES:
            if stage == "segmentation" and self.skip_segmentation:
                status[stage] = True
                continue
            if self.checkpoint.stage_done(class_name, stage):
                status[stage] = True
                continue
            t0 = time.time()
            ok = False
            for attempt in range(1 + max(0, self.retries)):
                try:
                    self._run_stage(stage, class_name)
                    ok = True
                    break
                except Exception:
                    traceback.print_exc()
                    if attempt < self.retries:
                        print(f"[sweep] {class_name} / {stage}: retry "
                              f"{attempt + 1}/{self.retries}")
            self.checkpoint.mark(class_name, stage, ok)
            status[stage] = ok
            print(f"[sweep] {class_name} / {stage}: {'ok' if ok else 'FAILED'} "
                  f"({time.time() - t0:.1f}s)")
            if not ok:
                break  # later stages depend on this one
        return status

    def _amortized_projection(self, classes: Sequence[str]) -> None:
        """Projection scene-outer for every class whose segmentation is
        complete, sharing each scene's depth upload; falls back to the
        per-class stage on any error."""
        pending = [
            c for c in classes
            if (self.skip_segmentation or self.checkpoint.stage_done(c, "segmentation"))
            and not self.checkpoint.stage_done(c, "projection")
            and os.path.isdir(os.path.join(self.cfg.paths.mask_2d_dir, c))
        ]
        if len(pending) < 2:
            return
        from beyondff_tpu_torch.pipeline import projection

        t0 = time.time()
        try:
            projection.run_classes(self.cfg, pending, device=self.device)
        except Exception:
            traceback.print_exc()
            print("[sweep] amortized projection failed; classes fall back to the "
                  "per-class stage")
            return
        for c in pending:
            self.checkpoint.mark(c, "projection", True)
        self.amortized["projection"].extend(pending)
        print(f"[sweep] amortized projection: {len(pending)} classes "
              f"({time.time() - t0:.1f}s)")

    def run(self, classes: Optional[Sequence[str]] = None, skip: Sequence[str] = DEFAULT_SKIP,
            amortize_segmentation: bool = False) -> Dict[str, Dict[str, bool]]:
        classes = classes if classes is not None else default_class_list()
        todo = [c for c in classes if c not in skip]
        if self.hosts > 1:
            from beyondff_tpu_torch.parallel.frames import frame_group

            if frame_group() is not None:
                raise RuntimeError("a sweep over several hosts gives each rank its own "
                                   "classes; it cannot run inside shard_frames, whose "
                                   "ranks must make the same calls")
            todo = host_partition(todo, self.hosts, self.host)
            print(f"[sweep] host {self.host}/{self.hosts}: {len(todo)} classes of the partition")
        if not self.use_subprocess:
            if amortize_segmentation and not self.skip_segmentation:
                self._amortized_segmentation(todo)
            if self.amortize_projection:
                self._amortized_projection(todo)
        return {c: self.process_class(c) for c in todo}
