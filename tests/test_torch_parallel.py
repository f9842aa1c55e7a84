"""Port parallel layer (beyondff_tpu_torch.parallel) vs the JAX package's.

The multi-rank cases run in spawned CPU processes joined in one gloo group
(``parallel/dryrun.launch``: a ``file://`` rendezvous under ``tmp_path``, a
60 s group timeout, children killed at a deadline), gathered into two
spawns: one of four ranks for the mesh, the 2 x 2 dp x tp CLIP step, the
tensor-parallel inference and the four frame-sharded lifts, and
``dryrun_multichip(4)``. The workers below import no JAX (the spawned
children import this module); the JAX references run in the test process,
on the 8 virtual devices of tests/conftest.py.
"""

import numpy as np
import pytest
import torch
from torch import nn
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

from beyondff_tpu_torch.parallel import dryrun
from beyondff_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
N_RANKS = 4
LIFT = {"n": 3000, "h": 16, "w": 24, "m": 3, "f": 8}


@pytest.fixture
def jx():
    """The JAX package's modules, imported only by the tests that compare
    against them."""
    import types

    import jax.numpy as jnp

    from beyondff_tpu.models import clip as jclip
    from beyondff_tpu.models import sam as jsam
    from beyondff_tpu.models.gdino import GroundingDINO
    from beyondff_tpu.parallel import lift as jlift
    from beyondff_tpu.parallel import mesh as jmesh

    return types.SimpleNamespace(jnp=jnp, clip=jclip, sam=jsam, gdino=GroundingDINO,
                                 lift=jlift, mesh=jmesh)


# ------------------------------------------------------------ shared inputs
def _clip_batch():
    from beyondff_tpu_torch.models import clip as tclip

    c = tclip.PRESETS["test"]
    rng = np.random.default_rng(1)
    images = rng.normal(size=(4, c.image_resolution, c.image_resolution, 3)).astype(np.float32)
    tokens = rng.integers(1, c.vocab_size, (4, c.context_length))
    return torch.from_numpy(images), torch.from_numpy(tokens)


def _lift_inputs():
    """Eight frames of a small scene: points, fused projections, depth,
    dense masks, their packed words and their RLE run bounds."""
    from beyondff_tpu_torch.core import geometry, rle

    n, h, w, m, f = (LIFT[k] for k in ("n", "h", "w", "m", "f"))
    rng = np.random.default_rng(2)
    pcd_h = geometry.homogenize(rng.uniform([-1, -1, 1], [1, 1, 3], (n, 3)).astype(np.float32))
    intr = np.array([[12.0, 0, w / 2], [0, 12.0, h / 2], [0, 0, 1.0]])
    poses = [np.eye(4) for _ in range(f)]
    for i, pose in enumerate(poses):
        pose[0, 3] = 0.05 * i
    projs = np.stack([geometry.fuse_projection(intr, p).astype(np.float32) for p in poses])
    depths = rng.uniform(1, 3, (f, h, w)).astype(np.float32)
    masks = rng.random((f, m, h * w)) < 0.4
    valid = np.ones((f, m), bool)
    valid[3, 1] = False
    packed = np.stack([geometry.pack_masks(mm) for mm in masks])
    st = np.full((f, m, 256), h * w + 1, np.int32)
    en = np.zeros((f, m, 256), np.int32)
    for i in range(f):
        for j in range(m):
            s0, e0 = rle.rle_bounds(rle.rle_encode(masks[i, j]))
            st[i, j, :len(s0)] = s0
            en[i, j, :len(e0)] = e0
    return {"pcd_h": pcd_h, "projs": projs, "depths": depths, "masks": masks,
            "valid": valid, "packed": packed, "starts": st, "ends": en}


def _port_lifts(mesh_or_none, x):
    """The four lifts: sharded over ``mesh`` or, with None, core.geometry's."""
    from beyondff_tpu_torch.core import geometry
    from beyondff_tpu_torch.parallel import lift

    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    packed = t["packed"].long()
    m = LIFT["m"]
    if mesh_or_none is None:
        fns = {"dense": geometry.lift_frames,
               "packed": lambda *a: geometry.lift_frames_packed(*a, n_masks=m),
               "rle": geometry.lift_frames_rle, "view_counts": geometry.view_counts}
    else:
        fns = {"dense": lift.make_sharded_lift(mesh_or_none),
               "packed": lift.make_sharded_lift_packed(mesh_or_none, n_masks=m),
               "rle": lift.make_sharded_lift_rle(mesh_or_none),
               "view_counts": lift.make_sharded_view_counts(mesh_or_none)}
    base = (t["pcd_h"], t["projs"], t["depths"])
    outs = {"dense": fns["dense"](*base, t["masks"], t["valid"]),
            "packed": fns["packed"](*base, packed),
            "rle": fns["rle"](*base, t["starts"], t["ends"]),
            "view_counts": (fns["view_counts"](*base),)}
    return {k: [o.numpy() for o in v] for k, v in outs.items()}


def _small_models(kind):
    from beyondff_tpu_torch.models import layers
    from beyondff_tpu_torch.models import sam as tsam
    from beyondff_tpu_torch.models.gdino import model as tgdino

    make = {"sam": lambda: tsam.SAMModule(tsam.PRESETS["test"]),
            "gdino": lambda: tgdino.GDINOModule(tgdino.PRESETS["test"])}[kind]
    return layers.build(make, torch.device("cpu"), seed=6)


def _tp_inference(mesh):
    """SAM's encoder and the Grounding-DINO forward at the "test" presets,
    replicated and with their Linears sharded over ``model``."""
    from torch.distributed.tensor import DTensor

    rng = np.random.default_rng(3)
    out = {}
    sam = _small_models("sam")
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
    gd = _small_models("gdino")
    h, w = gd.cfg.image_size
    img = torch.from_numpy(rng.normal(size=(1, h, w, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(1, gd.cfg.bert.vocab_size, (1, 6)))
    text = (ids, torch.ones(1, 6, 6, dtype=torch.bool), torch.ones(1, 6, dtype=torch.bool),
            torch.zeros(1, 6, dtype=torch.long))
    with torch.no_grad():
        out["sam_ref"] = sam.encode(x).numpy()
        out["gdino_ref"] = [t.numpy() for t in gd(img, *text)]
        for name, module in (("sam", sam), ("gdino", gd)):
            tmesh.shard_params(module, mesh)
            out[f"{name}_sharded_linears"] = sum(
                isinstance(m, nn.Linear) and isinstance(m.weight, DTensor)
                for m in module.modules())
            out[f"{name}_requires_grad"] = any(p.requires_grad for p in module.parameters())
        out["sam"] = sam.encode(x).numpy()
        out["gdino"] = [t.numpy() for t in gd(img, *text)]
    return out


def _four_rank_worker(rank, n, lift_inputs):
    from torch.distributed.tensor import DTensor

    from beyondff_tpu_torch.models import clip as tclip
    from beyondff_tpu_torch.models import layers
    from beyondff_tpu_torch.training import trainer

    out = {}
    errors = []
    for kwargs in ({"data": 3, "model": 3}, {"data": -1, "model": 3}):
        try:
            tmesh.make_mesh(device_type="cpu", **kwargs)
        except ValueError as e:
            errors.append(str(e))
    out["mesh_errors"] = errors
    mesh22 = tmesh.make_mesh(data=-1, model=2, device_type="cpu")
    mesh41 = tmesh.make_mesh(data=4, model=1, device_type="cpu")
    out["mesh22"] = (tuple(mesh22.shape), mesh22.mesh_dim_names, mesh22.mesh.tolist())
    out["mesh41"] = (tuple(mesh41.shape), mesh41.mesh_dim_names)
    out["placements"] = (repr(tmesh.data_sharding(mesh22, 3, axis=-1)),
                         repr(tmesh.replicated(mesh22)))

    # the 2 x 2 dp x tp CLIP step on the global batch of 4
    clip = layers.build(lambda: tclip.CLIPModule(tclip.PRESETS["test"]), torch.device("cpu"),
                        seed=3)
    init, step = trainer.make_sharded_train_step(clip, mesh22, lr=1e-3)
    state = init()
    out["clip_sharded"] = sum(isinstance(p, DTensor) for p in state.module.parameters())
    state, loss = step(state, *_clip_batch())
    out["clip_loss"] = float(loss)
    out["clip_grads"] = {k: (p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad)
                         .numpy().copy() for k, p in state.module.named_parameters()}
    out["tp"] = _tp_inference(mesh22)
    out["lifts"] = _port_lifts(mesh41, lift_inputs)
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of four gloo ranks serving the tests below; results by rank."""
    return dryrun.launch(_four_rank_worker, N_RANKS, args=(_lift_inputs(),),
                         workdir=str(tmp_path_factory.mktemp("four_ranks")), timeout=240)


# ------------------------------------------------------------------- mesh
def test_make_mesh_shapes(four_ranks):
    for r in four_ranks:
        assert len(r["mesh_errors"]) == 2
        assert r["mesh22"] == ((2, 2), ("model", "data"), [[0, 1], [2, 3]])
        assert r["mesh41"] == ((1, 4), ("model", "data"))
        assert r["placements"] == ("(Replicate(), Shard(dim=2))", "(Replicate(), Replicate())")


# ------------------------------------------------------------------ TP rule
def _jax_marked(jx, kind):
    """The torch keys whose JAX leaves ``tensor_parallel_spec`` shards,
    found by carrying a marker tree (1 column, 2 row, 0 replicated) through
    the port's converter."""
    import jax
    from jax.sharding import PartitionSpec as P

    from beyondff_tpu_torch.models import convert

    jm = {"clip": jx.clip.CLIP, "sam": jx.sam.SAM, "gdino": jx.gdino}[kind].create("test")
    marks = {P(None, "model"): 1.0, P("model"): 1.0, P("model", None): 2.0}

    def mark(path, leaf):
        return np.full(np.shape(leaf), marks.get(jx.mesh.tensor_parallel_spec(path, leaf), 0.0),
                       np.float32)

    tree = jax.tree_util.tree_map_with_path(mark, jm.params)
    conv = {"clip": convert.clip_from_jax, "sam": convert.sam_from_jax,
            "gdino": convert.gdino_from_jax}[kind]
    return {k: set(np.unique(v.numpy()).tolist()) for k, v in conv(tree, jm.cfg).items()}


def _meta_module(kind):
    from beyondff_tpu_torch.models import clip as tclip
    from beyondff_tpu_torch.models import sam as tsam
    from beyondff_tpu_torch.models.gdino import model as tgdino

    return {"clip": lambda: tclip.CLIPModule(tclip.PRESETS["test"]),
            "sam": lambda: tsam.SAMModule(tsam.PRESETS["test"]),
            "gdino": lambda: tgdino.GDINOModule(tgdino.PRESETS["test"])}[kind]()


@pytest.mark.parametrize("kind", ["clip", "sam", "gdino"])
def test_tensor_parallel_spec_matches_jax(jx, kind):
    """The port's rule shards exactly the Linears whose JAX counterparts the
    JAX rule shards, column for column and row for row; the one exception
    is ``layers.Attention``'s packed ``in_proj_weight`` (JAX's q/k/v
    kernels), a bare parameter that stays replicated."""
    marked = _jax_marked(jx, kind)
    with torch.device("meta"):
        module = _meta_module(kind)
    linears = {name for name, m in module.named_modules() if isinstance(m, nn.Linear)}
    want, packed = {}, set()
    for key, vals in marked.items():
        if vals == {0.0}:
            continue
        owner, leaf = key.rsplit(".", 1)
        if leaf.startswith("in_proj_"):
            assert vals == {1.0}
            packed.add(owner)
            continue
        assert owner in linears and len(vals) == 1, key
        style = "column" if vals == {1.0} else "row"
        assert want.setdefault(owner, style) == style, key
    got = {}
    for name, m in module.named_modules():
        style = tmesh.tensor_parallel_spec(name, m)
        if style is not None:
            got[name] = "column" if isinstance(style, ColwiseParallel) else "row"
    assert got == want
    assert len(got) >= 6
    # every packed projection belongs to an attention the rule leaves replicated
    assert all(tmesh.tensor_parallel_spec(owner, module.get_submodule(owner)) is None
               for owner in packed)
    assert bool(packed) == (kind != "sam")


def test_tensor_parallel_spec_leaves_convolutions_replicated():
    """A name-matched convolution (SAM's patch embedding is also ``proj``)
    stays replicated, as the JAX rule's dense-kernels-only test keeps it."""
    conv = nn.Conv2d(3, 8, 2)
    assert tmesh.tensor_parallel_spec("image_encoder.patch_embed.proj", conv) is None
    assert tmesh.tensor_parallel_spec("blocks.0.attn.proj", conv) is None
    assert isinstance(tmesh.tensor_parallel_spec("blocks.0.attn.proj", nn.Linear(4, 4)),
                      RowwiseParallel)
    assert isinstance(tmesh.tensor_parallel_spec("blocks.0.attn.qkv", nn.Linear(4, 12)),
                      ColwiseParallel)
    assert tmesh.tensor_parallel_spec("blocks.0.norm1", nn.LayerNorm(4)) is None


# ------------------------------------------------------- dp x tp train step
def test_dp_tp_clip_step_matches_one_process_global_batch(four_ranks):
    """The 2 x 2 step's loss and averaged gradients equal one process's on
    the whole batch within 1e-5: this pins the all-gather's factor (its
    backward sums n copies of each rank's rows; the average over data
    divides them out)."""
    from beyondff_tpu_torch.models import clip as tclip
    from beyondff_tpu_torch.models import layers
    from beyondff_tpu_torch.training import trainer

    ref = layers.build(lambda: tclip.CLIPModule(tclip.PRESETS["test"]), torch.device("cpu"),
                       seed=3).train().requires_grad_(True)
    loss = trainer.clip_contrastive_loss(ref, *_clip_batch())
    loss.backward()
    for r in four_ranks:
        assert r["clip_sharded"] > 0
        np.testing.assert_allclose(r["clip_loss"], loss.item(), rtol=1e-5)
        grads = r["clip_grads"]
        assert set(grads) == {k for k, _ in ref.named_parameters()}
        for k, p in ref.named_parameters():
            want = p.grad.numpy()
            np.testing.assert_allclose(grads[k], want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                       err_msg=k)


# -------------------------------------------------------- TP inference
def test_tp_sharded_inference_matches_replicated(four_ranks):
    """SAM's encoder and the Grounding-DINO forward with their Linears
    sharded over model=2 equal the replicated ones, at the tolerances of
    tests/test_parallel.py's JAX counterpart, and the rule fires."""
    for r in four_ranks:
        tp = r["tp"]
        assert tp["sam_sharded_linears"] >= 8 and tp["gdino_sharded_linears"] >= 10
        assert not tp["sam_requires_grad"] and not tp["gdino_requires_grad"]
        np.testing.assert_allclose(tp["sam"], tp["sam_ref"], rtol=1e-4, atol=1e-5)
        (logits, boxes), (ref_logits, ref_boxes) = tp["gdino"], tp["gdino_ref"]
        np.testing.assert_allclose(boxes, ref_boxes, rtol=1e-4, atol=1e-4)
        fin = np.isfinite(ref_logits)
        np.testing.assert_array_equal(np.isfinite(logits), fin)
        np.testing.assert_allclose(logits[fin], ref_logits[fin], rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------ sharded lifts
KINDS = ["dense", "packed", "rle", "view_counts"]


def _gathered(four_ranks, kind):
    """The ranks' membership slices joined in rank order, and the summed
    counts, which every rank must hold alike."""
    outs = [r["lifts"][kind] for r in four_ranks]
    first = 0 if kind == "view_counts" else 1  # view_counts returns counts only
    for o in outs[1:]:
        for a, b in zip(o[first:], outs[0][first:]):
            np.testing.assert_array_equal(a, b)
    if kind == "view_counts":
        return outs[0]
    return [np.concatenate([o[0] for o in outs]), *outs[0][1:]]


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_lift_equals_geometry(four_ranks, kind):
    want = _port_lifts(None, _lift_inputs())[kind]
    got = _gathered(four_ranks, kind)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert want[-1].sum() > 0


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_lift_equals_jax_sharded_lift(four_ranks, jx, kind):
    """The JAX package's shard_map lifts on 8 virtual devices, same inputs."""
    x = _lift_inputs()
    jnp = jx.jnp
    mesh = jx.mesh.make_mesh(data=8, model=1)
    base = tuple(jnp.asarray(x[k]) for k in ("pcd_h", "projs", "depths"))
    if kind == "dense":
        out = jx.lift.make_sharded_lift(mesh)(*base, jnp.asarray(x["masks"]),
                                              jnp.asarray(x["valid"]))
    elif kind == "packed":
        out = jx.lift.make_sharded_lift_packed(mesh, n_masks=LIFT["m"])(
            *base, jnp.asarray(x["packed"]))
    elif kind == "rle":
        out = jx.lift.make_sharded_lift_rle(mesh)(*base, jnp.asarray(x["starts"]),
                                                  jnp.asarray(x["ends"]))
    else:
        out = (jx.lift.make_sharded_view_counts(mesh)(*base),)
    got = _gathered(four_ranks, kind)
    for a, b in zip(got, out):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_sharded_lift_rejects_frames_that_do_not_split():
    class OneOfThree:  # a mesh's data axis of 3 ranks, seen from rank 0
        def __getitem__(self, axis):
            return self

        def size(self):
            return 3

        def get_local_rank(self, axis):
            return 0

    from beyondff_tpu_torch.parallel import lift

    x = {k: torch.from_numpy(np.asarray(v)) for k, v in _lift_inputs().items()}
    with pytest.raises(ValueError, match="do not split"):
        lift.make_sharded_view_counts(OneOfThree())(x["pcd_h"], x["projs"], x["depths"])


# ------------------------------------------------------------------ dry run
def test_dryrun_multichip_four_ranks(tmp_path):
    out = dryrun.dryrun_multichip(4, workdir=str(tmp_path), timeout=240)
    assert out["mesh"] == [2, 2]
    assert np.isfinite(out["loss"]) and 0 <= out["gdino_max_score"] <= 1
    assert out["lift_viewed"] > 0


# ---------------------------------------------------------------- harness
def _fail_on_rank_one(rank, n):
    import time

    if rank == 1:
        raise ValueError("rank one fails")
    time.sleep(60)


def _sleep(rank, n):
    import time

    time.sleep(60)


def test_launch_reports_a_failing_rank_and_kills_the_rest(tmp_path):
    with pytest.raises(RuntimeError, match="rank one fails"):
        dryrun.launch(_fail_on_rank_one, 2, workdir=str(tmp_path), timeout=50)


def test_launch_kills_ranks_at_the_deadline(tmp_path):
    with pytest.raises(TimeoutError, match="unfinished"):
        dryrun.launch(_sleep, 1, workdir=str(tmp_path), timeout=8)
