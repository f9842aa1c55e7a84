"""ScanNet(-200/++/v2) instance-segmentation AP evaluation.

Protocol-parity rebuild of the reference engine
(reference: evaluation/eval/scannetv2_inst_eval.py, instance_eval_util.py).
The matching protocol — greedy per-GT assignment in confidence-agnostic
insertion order, duplicate matches demoted to false positives at their lower
score, void/group/small-GT ignore fractions, PR integration over unique score
thresholds with the [-0.5, 0, 0.5] convolution — is preserved number-for-
number; AP parity with the reference is asserted by tests/test_eval.py.

Vectorization (the reference computes every pred x gt intersection as a full
N-point ``logical_and`` pass, scannetv2_inst_eval.py:349): intersections with
*all* GT instances of a scene come from one ``np.bincount`` over the encoded
GT id array restricted to the prediction mask.

Kept CPU/NumPy deliberately: greedy matching is sequential, runs in seconds
per class, and bit-parity with the published protocol matters more than
device speed here (SURVEY.md §7). The port's copy of
beyondff_tpu/eval/instance_eval.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

# semantic-label offset applied before encoding: sem' = sem + offset
_SEM_OFFSET = {
    "scannetv2": -1,  # -2 + 1 (reference: scannetv2_inst_eval.py:270-281)
    "scannet200": -1,
    "replica": 0,
    "stpls3d": 0,
    "scannetpp": -104,
}


@dataclass
class _GtInstance:
    instance_id: int
    label_id: int
    vert_count: int
    box: Optional[np.ndarray] = None  # (6,) min/max corner, box-IoU mode
    # preds intersecting this gt, in pred order: (pred_index, intersection, iou)
    matched_preds: List[tuple] = field(default_factory=list)


@dataclass
class _PredInstance:
    pred_key: str  # unique per (scene, pred) — the greedy "visited" key
    label_id: Optional[int]
    vert_count: int
    confidence: float
    void_intersection: int
    # gts this pred intersects: (gt_ref, intersection, iou)
    matched_gts: List[tuple] = field(default_factory=list)


@dataclass
class _SceneMatch:
    gts: Dict[str, List[_GtInstance]]  # label -> gt instances (unique-id order)
    preds: Dict[str, List[_PredInstance]]  # label -> preds (input order)


class ScanNetEval:
    """AP evaluator. ``class_labels`` are 0-indexed names; pred ``label_id`` is 1-based."""

    def __init__(
        self,
        class_labels: Sequence[str],
        use_label: bool = True,
        dataset_name: str = "scannet200",
        min_region_size: Optional[int] = None,
    ):
        self.dataset_name = dataset_name
        self.encode_value = 10000 if dataset_name == "scannetpp" else 1000
        self.valid_class_labels = list(class_labels)
        self.valid_class_ids = np.arange(len(class_labels)) + 1
        self.id2label = {i + 1: lab for i, lab in enumerate(class_labels)}
        self.ious = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
        if min_region_size is None:
            min_region_size = 10 if dataset_name == "stpls3d" else 100
        self.min_region_size = min_region_size
        self.use_label = use_label
        self.eval_class_labels = (
            self.valid_class_labels if use_label else ["class_agnostic"]
        )

    # ------------------------------------------------------------ encoding
    def encode_gt(self, gt_sem: np.ndarray, gt_ins: np.ndarray) -> np.ndarray:
        """Per-point gt id = sem' * encode + ins' with the reference's offsets
        and ignore handling (scannetv2_inst_eval.py:269-289)."""
        sem = np.asarray(gt_sem).astype(np.int64) + _SEM_OFFSET.get(self.dataset_name, 1)
        sem[sem < 0] = 0
        ins = np.asarray(gt_ins).astype(np.int64) + 1
        ids = sem * self.encode_value + ins
        ids[ins < 0] = 0  # original instance < -1 => ignore
        return ids

    # ------------------------------------------------------------ matching
    def assign_instances_for_scan(
        self, preds: Sequence[Dict], gt_sem: np.ndarray, gt_ins: np.ndarray,
        scene_key: str = "",
    ) -> _SceneMatch:
        ids = self.encode_gt(gt_sem, gt_ins)

        # gt instance table, per label, in ascending unique-id order
        gts: Dict[str, List[_GtInstance]] = {lab: [] for lab in self.eval_class_labels}
        gt_by_id: Dict[int, _GtInstance] = {}
        uniq, counts = np.unique(ids, return_counts=True)
        for uid, cnt in zip(uniq, counts):
            if uid == 0:
                continue
            label_id = int(uid) // self.encode_value
            if label_id not in self.id2label:
                continue
            inst = _GtInstance(instance_id=int(uid), label_id=label_id, vert_count=int(cnt))
            gt_by_id[int(uid)] = inst
            key = self.id2label[label_id] if self.use_label else self.eval_class_labels[0]
            gts[key].append(inst)

        # void points: label part not a valid class (includes id 0)
        void = ~np.isin(ids // self.encode_value, self.valid_class_ids)

        # dense intersection lookup: bincount over gt ids inside each pred mask
        preds_out: Dict[str, List[_PredInstance]] = {lab: [] for lab in self.eval_class_labels}
        num_pred = 0
        for pred in preds:
            if self.use_label:
                label_id = int(pred["label_id"])
                if label_id not in self.id2label:
                    continue
                key = self.id2label[label_id]
            else:
                label_id, key = None, self.eval_class_labels[0]
            mask = np.not_equal(np.asarray(pred["pred_mask"]), 0)
            assert mask.shape[0] == ids.shape[0], "pred mask / gt point count mismatch"
            vert_count = int(np.count_nonzero(mask))
            if vert_count < self.min_region_size:
                continue

            rec = _PredInstance(
                # scene_key makes the greedy `visited` key collision-proof even
                # when callers omit scan_id (the reference KeyErrors there)
                pred_key=f"{scene_key}_{pred.get('scan_id', '')}_{num_pred}",
                label_id=label_id,
                vert_count=vert_count,
                confidence=float(pred["conf"]),
                void_intersection=int(np.count_nonzero(void & mask)),
            )
            inside = ids[mask]
            inter_ids, inter_counts = np.unique(inside, return_counts=True)
            inter_map = dict(zip(inter_ids.tolist(), inter_counts.tolist()))
            for gt in gts[key]:
                inter = inter_map.get(gt.instance_id, 0)
                if inter > 0:
                    iou = inter / (gt.vert_count + vert_count - inter)
                    gt.matched_preds.append((rec, inter, iou))
                    rec.matched_gts.append((gt, inter, iou))
            num_pred += 1
            preds_out[key].append(rec)

        return _SceneMatch(gts=gts, preds=preds_out)

    def assign_boxes_for_scan(
        self, preds: Sequence[Dict], gt_sem: np.ndarray, gt_ins: np.ndarray,
        coords: np.ndarray, scene_key: str = "",
    ) -> _SceneMatch:
        """Axis-aligned 3D box-IoU matching (reference: scannetv2_inst_eval.py
        :366-459): GT boxes from per-instance coordinate extents, preds carry
        a (6,) min/max ``box``. Unmatched-pred bookkeeping uses
        void_intersection=0 / vert_count=1 (the reference's box path never
        sets these fields and would fault on them)."""
        ids = self.encode_gt(gt_sem, gt_ins)
        gts: Dict[str, List[_GtInstance]] = {lab: [] for lab in self.eval_class_labels}
        uniq, counts = np.unique(ids, return_counts=True)
        for uid, cnt in zip(uniq, counts):
            if uid == 0:
                continue
            label_id = int(uid) // self.encode_value
            if label_id not in self.id2label:
                continue
            sel = ids == uid
            box = np.concatenate([coords[sel].min(0), coords[sel].max(0)])
            inst = _GtInstance(instance_id=int(uid), label_id=label_id,
                               vert_count=int(cnt), box=box)
            key = self.id2label[label_id] if self.use_label else self.eval_class_labels[0]
            gts[key].append(inst)

        preds_out: Dict[str, List[_PredInstance]] = {lab: [] for lab in self.eval_class_labels}
        num_pred = 0
        for pred in preds:
            if self.use_label:
                label_id = int(pred["label_id"])
                if label_id not in self.id2label:
                    continue
                key = self.id2label[label_id]
            else:
                label_id, key = None, self.eval_class_labels[0]
            box = np.asarray(pred["box"], np.float64)
            pred_vol = float(np.prod(np.clip(box[3:] - box[:3], 0, None)))
            rec = _PredInstance(
                pred_key=f"{scene_key}_{pred.get('scan_id', '')}_{num_pred}",
                label_id=label_id, vert_count=1, confidence=float(pred["conf"]),
                void_intersection=0,
            )
            for gt in gts[key]:
                lo = np.maximum(gt.box[:3], box[:3])
                hi = np.minimum(gt.box[3:], box[3:])
                inter = float(np.prod(np.clip(hi - lo, 0, None)))
                if inter > 0:
                    gt_vol = float(np.prod(np.clip(gt.box[3:] - gt.box[:3], 0, None)))
                    iou = inter / (gt_vol + pred_vol - inter)
                    gt.matched_preds.append((rec, inter, iou))
                    rec.matched_gts.append((gt, inter, iou))
            num_pred += 1
            preds_out[key].append(rec)
        return _SceneMatch(gts=gts, preds=preds_out)

    def evaluate_box(
        self, pred_list, gt_sem_list, gt_ins_list, coords_list, verbose: bool = True,
        workers: int = 1,
    ) -> Dict:
        """Box-IoU AP over scenes (reference: scannetv2_inst_eval.py:608-636).
        preds per scene: {scan_id, label_id, conf, box (6,) min/max corners}.

        ``workers > 1`` fans the per-scene matching over a process pool like
        the reference's ``mp.Pool(16)`` (scannetv2_inst_eval.py:620-623);
        the default stays serial because matching is cheap relative to pool
        pickling on few-core hosts."""
        if workers > 1 and len(gt_sem_list) > 1:
            from concurrent.futures import ProcessPoolExecutor

            with ProcessPoolExecutor(max_workers=workers) as pool:
                scenes = list(pool.map(
                    self.assign_boxes_for_scan, pred_list, gt_sem_list,
                    gt_ins_list, coords_list,
                    [str(i) for i in range(len(gt_sem_list))],
                ))
        else:
            scenes = [
                self.assign_boxes_for_scan(pred_list[i], gt_sem_list[i], gt_ins_list[i],
                                           coords_list[i], scene_key=str(i))
                for i in range(len(gt_sem_list))
            ]
        ap, rc = self.evaluate_matches(scenes)
        avgs = self.compute_averages(ap, rc)
        if verbose:
            print(format_class_table(avgs, self.eval_class_labels))
        return avgs

    # ----------------------------------------------------------- AP curves
    def evaluate_matches(self, scenes: Sequence[_SceneMatch], collect_pr: bool = False):
        n_labels, n_ious = len(self.eval_class_labels), len(self.ious)
        ap = np.zeros((n_labels, n_ious))
        rc = np.zeros((n_labels, n_ious))
        self.pr_curves: Dict = {}  # (label, iou_th) -> (precision, recall)

        for oi, iou_th in enumerate(self.ious):
            visited = {
                p.pred_key: False
                for sc in scenes
                for lab in self.eval_class_labels
                for p in sc.preds[lab]
            }
            for li, label in enumerate(self.eval_class_labels):
                y_true: List[float] = []
                y_score: List[float] = []
                hard_fn = 0
                has_gt = has_pred = False
                for sc in scenes:
                    gt_list = [
                        g
                        for g in sc.gts[label]
                        if g.instance_id >= self.encode_value
                        and g.vert_count >= self.min_region_size
                    ]
                    pred_list = sc.preds[label]
                    has_gt |= bool(gt_list)
                    has_pred |= bool(pred_list)

                    cur_true: List[float] = [1.0] * len(gt_list)
                    cur_score: List[float] = [-float("inf")] * len(gt_list)
                    cur_match: List[bool] = [False] * len(gt_list)
                    for gi, gt in enumerate(gt_list):
                        found = False
                        for pred, _inter, iou in gt.matched_preds:
                            if visited[pred.pred_key] or iou <= iou_th:
                                continue
                            conf = pred.confidence
                            if cur_match[gi]:
                                # duplicate match: lower-scored one becomes FP
                                lo = min(cur_score[gi], conf)
                                cur_score[gi] = max(cur_score[gi], conf)
                                cur_true.append(0.0)
                                cur_score.append(lo)
                                cur_match.append(True)
                            else:
                                found = True
                                cur_match[gi] = True
                                cur_score[gi] = conf
                                visited[pred.pred_key] = True
                        if not found:
                            hard_fn += 1
                    y_true += [t for t, m in zip(cur_true, cur_match) if m]
                    y_score += [s for s, m in zip(cur_score, cur_match) if m]

                    # unmatched preds -> FP unless mostly ignore-region
                    for pred in pred_list:
                        if any(iou > iou_th for _gt, _i, iou in pred.matched_gts):
                            continue
                        num_ignore = pred.void_intersection
                        for gt, inter, _iou in pred.matched_gts:
                            if gt.instance_id < self.encode_value:
                                num_ignore += inter
                            if gt.vert_count < self.min_region_size:
                                num_ignore += inter
                        if num_ignore / pred.vert_count <= iou_th:
                            y_true.append(0.0)
                            y_score.append(pred.confidence)

                if has_gt and has_pred:
                    ap[li, oi], rc[li, oi], curve = _pr_integrate(
                        np.asarray(y_true), np.asarray(y_score), hard_fn
                    )
                    if collect_pr and curve is not None:
                        self.pr_curves[(label, float(iou_th))] = curve
                elif has_gt:
                    ap[li, oi] = rc[li, oi] = 0.0
                else:
                    ap[li, oi] = rc[li, oi] = float("nan")
        return ap, rc

    def compute_averages(self, aps: np.ndarray, rcs: np.ndarray) -> Dict:
        o50 = np.isclose(self.ious, 0.5)
        o25 = np.isclose(self.ious, 0.25)
        core = ~o25
        avg = {
            "all_ap": np.nanmean(aps[:, core]),
            "all_ap_50%": np.nanmean(aps[:, o50]),
            "all_ap_25%": np.nanmean(aps[:, o25]),
            "all_rc": np.nanmean(rcs[:, core]),
            "all_rc_50%": np.nanmean(rcs[:, o50]),
            "all_rc_25%": np.nanmean(rcs[:, o25]),
            "classes": {},
        }
        for li, label in enumerate(self.eval_class_labels):
            avg["classes"][label] = {
                "ap": np.average(aps[li, core]),
                "ap50%": np.average(aps[li, o50]),
                "ap25%": np.average(aps[li, o25]),
                "rc": np.average(rcs[li, core]),
                "rc50%": np.average(rcs[li, o50]),
                "rc25%": np.average(rcs[li, o25]),
            }
        return avg

    # --------------------------------------------------------------- evaluate
    def evaluate(
        self,
        pred_list: Sequence[Sequence[Dict]],
        gt_sem_list: Sequence[np.ndarray],
        gt_ins_list: Sequence[np.ndarray],
        exp_path: Optional[str] = None,
        verbose: bool = True,
    ) -> Dict:
        """preds per scene: dicts {scan_id, label_id (1-based), conf, pred_mask (N,)}."""
        scenes = [
            self.assign_instances_for_scan(pred_list[i], gt_sem_list[i], gt_ins_list[i],
                                           scene_key=str(i))
            for i in range(len(gt_sem_list))
        ]
        ap, rc = self.evaluate_matches(scenes, collect_pr=True)
        avgs = self.compute_averages(ap, rc)
        if exp_path:
            import os

            os.makedirs(exp_path, exist_ok=True)
            self.write_result_file(avgs, os.path.join(exp_path, "result.txt"))
        if verbose:
            if self.dataset_name == "scannet200" and self.use_label:
                print(format_scannet200_report(avgs, self.eval_class_labels))
            else:
                print(format_class_table(avgs, self.eval_class_labels))
        return avgs

    def write_result_file(self, avgs: Dict, filename: str) -> None:
        """CSV rows per class + overall line (reference: scannetv2_inst_eval.py:549-562)."""
        with open(filename, "w") as f:
            f.write("class,class id,ap,ap50,ap25\n")
            for name in self.eval_class_labels:
                c = avgs["classes"][name]
                f.write(
                    ",".join(
                        str(x)
                        for x in [name, c["ap"], c["ap50%"], c["ap25%"], c["rc"], c["rc50%"], c["rc25%"]]
                    )
                    + "\n"
                )
            f.write("all_ap, all_ap50, all_ap25, all_rc, all_rc50, all_rc25\n")
            f.write(
                ",".join(
                    str(avgs[k])
                    for k in ["all_ap", "all_ap_50%", "all_ap_25%", "all_rc", "all_rc_50%", "all_rc_25%"]
                )
                + "\n"
            )


def _pr_integrate(y_true: np.ndarray, y_score: np.ndarray, hard_fn: int):
    """Precision/recall curve over unique score thresholds; AP by the
    reference's convolution integration (scannetv2_inst_eval.py:172-228)."""
    order = np.argsort(y_score)
    y_score, y_true = y_score[order], y_true[order]
    if y_true.size == 0:
        return 0.0, 0.0, None
    cum = np.cumsum(y_true)
    thresholds, first_idx = np.unique(y_score, return_index=True)
    n_curve = len(first_idx) + 1
    n_examples = len(y_score)
    n_true = cum[-1]
    precision = np.zeros(n_curve)
    recall = np.zeros(n_curve)
    cum_ext = np.append(cum, 0)  # cum_ext[-1] == 0 for idx_scores == 0
    for k, idx in enumerate(first_idx):
        below = cum_ext[idx - 1]  # true positives scored strictly below threshold
        tp = n_true - below
        fp = n_examples - idx - tp
        fn = below + hard_fn
        precision[k] = tp / (tp + fp)
        recall[k] = tp / (tp + fn)
    rc_first = recall[0]
    precision[-1] = 1.0
    recall[-1] = 0.0
    r = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(r, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths)), float(rc_first), (precision, recall)


def plot_pr_curves(pr_curves: Dict, out_dir: str) -> List[str]:
    """One PNG per class with all IoU thresholds' PR curves
    (reference: scannetv2_inst_eval.py:462-492)."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    by_label: Dict[str, Dict] = {}
    for (label, iou_th), curve in pr_curves.items():
        by_label.setdefault(label, {})[iou_th] = curve
    out = []
    for label, curves in by_label.items():
        fig = plt.figure(figsize=(6, 6))
        for iou_th in sorted(curves):
            precision, recall = curves[iou_th]
            if len(precision) > 1:
                plt.plot(recall, precision, marker="o", linestyle="-",
                         markersize=2, label=f"IoU={iou_th:.2f}")
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.title(f"Precision-Recall: {label}")
        plt.xlim([0, 1])
        plt.ylim([0, 1])
        plt.grid(True)
        plt.legend(loc="upper right", fontsize=7)
        path = os.path.join(out_dir, f"{label.replace(' ', '_')}_pr_curve.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        out.append(path)
    return out


# ------------------------------------------------------------------ reports
def format_class_table(avgs: Dict, labels: Sequence[str]) -> str:
    lines = [f"{'what':<16}{'AP':>8}{'AP_50%':>8}{'AP_25%':>8}{'AR':>8}{'RC_50%':>8}{'RC_25%':>8}"]
    for name in labels:
        c = avgs["classes"][name]
        lines.append(
            f"{name:<16}{c['ap']:>8.3f}{c['ap50%']:>8.3f}{c['ap25%']:>8.3f}"
            f"{c['rc']:>8.3f}{c['rc50%']:>8.3f}{c['rc25%']:>8.3f}"
        )
    lines.append(
        f"{'average':<16}{avgs['all_ap']:>8.3f}{avgs['all_ap_50%']:>8.3f}{avgs['all_ap_25%']:>8.3f}"
        f"{avgs['all_rc']:>8.3f}{avgs['all_rc_50%']:>8.3f}{avgs['all_rc_25%']:>8.3f}"
    )
    return "\n".join(lines)


def format_scannet200_report(avgs: Dict, labels: Sequence[str]) -> str:
    """Head/common/tail + base/novel breakdown (scannetv2_inst_eval.py:638-729)."""
    from beyondff_tpu_torch.data import scannet200 as s2

    groups = {
        "Head AP": s2.HEAD_CATS_SCANNET_200,
        "Common AP": s2.COMMON_CATS_SCANNET_200,
        "Tail AP": s2.TAIL_CATS_SCANNET_200,
        "Base AP": s2.BASE_CLASSES_SCANNET200,
        "Novel AP": s2.NOVEL_CLASSES_SCANNET200,
    }
    rows = {k: [] for k in groups}
    overall = []
    for name in labels:
        if name not in s2.VALID_CLASS_IDS_200_VALIDATION:
            continue
        c = avgs["classes"][name]
        triple = np.array([c["ap"], c["ap50%"], c["ap25%"]])
        for key, members in groups.items():
            if name in members:
                rows[key].append(triple)
        overall.append(triple)
    lines = ["ScanNet200 Evaluation", f"{'what':<16}{'AP':>8}{'AP_50%':>8}{'AP_25%':>8}"]
    for key in groups:
        if rows[key]:
            m = np.nanmean(np.stack(rows[key]), axis=0)
            lines.append(f"{key:<16}{m[0]:>8.3f}{m[1]:>8.3f}{m[2]:>8.3f}")
    if overall:
        m = np.nanmean(np.stack(overall), axis=0)
        lines.append(f"{'AP':<16}{m[0]:>8.3f}{m[1]:>8.3f}{m[2]:>8.3f}")
    return "\n".join(lines)
