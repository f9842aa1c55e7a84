"""Port training path (beyondff_tpu_torch.training, utils/mfu.py) vs the JAX
package's.

The same seeded numpy inputs go through both packages at the ``"test"``
presets, with the JAX weights carried into the port by
``models/convert.py``; gradient trees cross through the same converters.
The optimizer is held apart from the losses: Adam's first step is close to
lr * sign(g), so a parameter whose gradient is float noise moves by up to
lr either way, and equal updates need equal gradients. The steps run on a
one-rank gloo group (``file://`` rendezvous under ``tmp_path``); the
multi-rank steps are in tests/test_torch_parallel.py.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from beyondff_tpu.models import clip as jclip
from beyondff_tpu.models import sam as jsam
from beyondff_tpu.parallel import mesh as jmesh
from beyondff_tpu.training import sam_finetune as jft
from beyondff_tpu.training import trainer as jtrainer
from beyondff_tpu_torch.kernels import dispatch
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert, layers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.parallel import mesh as tmesh
from beyondff_tpu_torch.training import checkpoint as tckpt
from beyondff_tpu_torch.training import sam_finetune as tft
from beyondff_tpu_torch.training import trainer as ttrainer
from beyondff_tpu_torch.utils import mfu

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo group for the steps; torn down after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(kind, jmodel):
    make = {"clip": lambda: tclip.CLIPModule(jmodel.cfg), "sam": lambda: tsam.SAMModule(jmodel.cfg)}
    conv = {"clip": convert.clip_from_jax, "sam": convert.sam_from_jax}[kind]
    module = layers.build(make[kind], CPU)
    module.load_state_dict(conv(_np_tree(jmodel.params), jmodel.cfg))
    return module


def _clip_batch(rng, cfg, b=4):
    n = cfg.image_resolution
    images = rng.normal(size=(b, n, n, 3)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 1, (b, cfg.context_length)).astype(np.int32)
    tokens[:, 6] = cfg.vocab_size - 1  # EOT
    return images, tokens


def _sam_batch(rng, cfg, b=8):
    g = cfg.img_size // cfg.patch_size
    emb = rng.normal(size=(b, g, g, cfg.prompt_dim)).astype(np.float32)
    lo = rng.uniform(0, cfg.img_size / 2, (b, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(8, cfg.img_size / 2, (b, 2))], 1)
    targets = (rng.random((b, 4 * g, 4 * g)) < 0.3).astype(np.float32)
    return emb, boxes.astype(np.float32), targets


def _np(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()


def _grads(module):
    return {k: _np(p.grad) for k, p in module.named_parameters()}


def _assert_grads_close(got, want, rtol):
    """Each gradient tensor within ``rtol`` of its own largest entry. A
    tensor whose largest entry is below 1e-4 of the tree's largest
    holds a zero gradient computed in floats (e.g. a key bias, which the
    softmax cancels): it is held at that floor instead."""
    assert set(got) == set(want)
    want = {k: np.asarray(w) for k, w in want.items()}
    floor = 1e-4 * max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(got[key], w, rtol=rtol, atol=rtol * scale, err_msg=key)


# --------------------------------------------------------------------- CLIP
def test_clip_forward_logits_match_jax(rng):
    jm = jclip.CLIP.create("test", seed=4)
    tm = _port("clip", jm)
    images, tokens = _clip_batch(rng, jm.cfg)
    want = np.asarray(jm.module.apply(jm.params, jnp.asarray(images), jnp.asarray(tokens)))
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(tokens).long()).numpy()
    assert got.shape == (4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_clip_contrastive_loss_and_grads_match_jax(rng):
    jm = jclip.CLIP.create("test", seed=4)
    tm = _port("clip", jm).train().requires_grad_(True)
    images, tokens = _clip_batch(rng, jm.cfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtrainer.clip_contrastive_loss(jm.module, p, jnp.asarray(images),
                                                 jnp.asarray(tokens)))(jm.params)
    loss = ttrainer.clip_contrastive_loss(tm, torch.from_numpy(images),
                                          torch.from_numpy(tokens).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    _assert_grads_close(_grads(tm), convert.clip_from_jax(_np_tree(jgrads), jm.cfg), 1e-4)


# ---------------------------------------------------------------------- SAM
def test_mask_loss_and_grad_match_jax(rng):
    logits = rng.normal(size=(3, 16, 16)).astype(np.float32) * 3
    target = (rng.random((3, 16, 16)) < 0.4).astype(np.float32)
    jloss, jgrad = jax.value_and_grad(jft.mask_loss)(jnp.asarray(logits), jnp.asarray(target))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = tft.mask_loss(x, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-4 * np.abs(jgrad).max())


def test_decoder_loss_and_grads_match_jax(rng):
    jm = jsam.SAM.create("test", seed=5)
    tm = _port("sam", jm).train().requires_grad_(True)
    emb, boxes, targets = _sam_batch(rng, jm.cfg, b=3)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jft.decoder_loss(jm.module, p, jnp.asarray(emb), jnp.asarray(boxes),
                                   jnp.asarray(targets)))(jm.params)
    loss = tft.decoder_loss(tm, torch.from_numpy(emb), torch.from_numpy(boxes),
                            torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    want = convert.sam_from_jax(_np_tree(jgrads), jm.cfg)
    got = {k: (p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32))
           for k, p in tm.named_parameters()}
    # the loss reaches the prompt encoder and mask decoder only; JAX gives
    # every other leaf a zero gradient, which the step's reduce_grads fills in
    assert all(not want[k].any() for k, p in tm.named_parameters() if p.grad is None)
    _assert_grads_close(got, want, 1e-4)


# ---------------------------------------------------------------- optimizer
def test_adamw_matches_optax_on_identical_gradients(rng):
    """Three steps of the same gradients: a large one, one of float noise
    (Adam moves it by ~lr all the same), and a zero one (decay only)."""
    shapes = {"w": (6, 5), "noise": (7,), "zero": (4, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lr, wd = 1e-3, 0.01
    tx = optax.adamw(lr, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ttrainer.make_optimizer(list(tp.values()), lr=lr, weight_decay=wd)
    for _ in range(3):
        grads = {"w": rng.normal(size=shapes["w"]).astype(np.float32),
                 "noise": (rng.normal(size=shapes["noise"]) * 1e-9).astype(np.float32),
                 "zero": np.zeros(shapes["zero"], np.float32)}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=0, err_msg=k)


def test_sam_finetune_step_matches_jax(rng, group):
    """Five steps of the JAX step on 8 virtual devices and the port's on
    one rank: the losses agree and fall; after every step each image-encoder
    leaf equals JAX's, decayed by (1 - lr * wd) though its gradient is zero
    (a fault of the JAX package that the port keeps: 22 of the 37 "test"
    encoder leaves are non-zero and move); the decoder moves. JAX computes
    p - lr * wd * p and torch p * (1 - lr * wd), each rounding once a step
    in its own way, so after k steps the two lie within k float32 ulps
    (rtol k * 2^-23)."""
    lr, wd = 5e-3, 0.01
    jm = jsam.SAM.create("test", seed=0)
    emb, boxes, targets = _sam_batch(rng, jm.cfg)
    jinit, jstep = jft.make_sam_finetune_step(jm.module, jmesh.make_mesh(data=8, model=1), lr=lr)
    jstate = jinit(jm.params)
    tm = _port("sam", jm)
    tinit, tstep = tft.make_sam_finetune_step(tm, tmesh.make_mesh(device_type="cpu"), lr=lr)
    tstate = tinit()
    assert not tm.training and not any(p.requires_grad for p in tm.parameters())
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    enc = [k for k in start if tft.frozen(k)]
    assert len(enc) == 37
    jlosses, tlosses = [], []
    for step in range(1, 6):
        jstate, jl = jstep(jstate, jnp.asarray(emb), jnp.asarray(boxes), jnp.asarray(targets))
        tstate, tl = tstep(tstate, torch.from_numpy(emb), torch.from_numpy(boxes),
                           torch.from_numpy(targets))
        jlosses.append(float(jl))
        tlosses.append(float(tl))
        want = convert.sam_from_jax(_np_tree(jstate.params), jm.cfg)
        now = tstate.module.state_dict()
        for k in enc:
            np.testing.assert_allclose(now[k].numpy(), want[k].numpy(), rtol=step * 2.0 ** -23,
                                       atol=0, err_msg=f"{k} after step {step}")
    assert tstate.step == 5 and np.isfinite(tlosses).all()
    assert tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-4)
    moved = 0
    for k in enc:
        np.testing.assert_allclose(now[k].numpy(), start[k].numpy() * (1 - lr * wd) ** 5,
                                   rtol=5 * 2.0 ** -23, atol=0, err_msg=k)
        moved += not torch.equal(now[k], start[k])
    assert moved == 22
    dec = [k for k in now if k.startswith("mask_decoder.transformer.layers.0.self_attn")]
    assert dec and all(not torch.allclose(now[k], start[k]) for k in dec)


def test_train_step_keeps_the_callers_module_and_averages_nothing_on_one_rank(rng, group):
    """init_state copies: the caller's inference module keeps its weights,
    eval mode and frozen gradients; one step on one rank is plain AdamW on
    the global-batch gradient."""
    jm = jclip.CLIP.create("test", seed=1)
    tm = _port("clip", jm)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    init, step = ttrainer.make_sharded_train_step(tm, tmesh.make_mesh(device_type="cpu"), lr=1e-3)
    state = init()
    images, tokens = (torch.from_numpy(a) for a in _clip_batch(rng, jm.cfg))
    tokens = tokens.long()
    ref = _port("clip", jm).train().requires_grad_(True)
    ttrainer.clip_contrastive_loss(ref, images, tokens).backward()
    state, loss = step(state, images, tokens)
    assert state.step == 1 and state.module.training
    assert all(torch.equal(tm.state_dict()[k], v) for k, v in before.items())
    assert not tm.training and not any(p.requires_grad for p in tm.parameters())
    _assert_grads_close(_grads(state.module), _grads(ref), 1e-6)


# --------------------------------------------------------------- checkpoint
def test_checkpoint_round_trip_is_bit_exact(rng, group, tmp_path):
    jm = jclip.CLIP.create("test", seed=2)
    mesh = tmesh.make_mesh(device_type="cpu")
    init, step = ttrainer.make_sharded_train_step(_port("clip", jm), mesh, lr=1e-3)
    images, tokens = (torch.from_numpy(a) for a in _clip_batch(rng, jm.cfg))
    tokens = tokens.long()
    state = init()
    for _ in range(2):
        state, _ = step(state, images, tokens)
    path = str(tmp_path / "ckpt" / "state.pt")
    tckpt.save_params(path, state)
    raw = tckpt.load_params(path)
    assert raw["step"] == 2 and set(raw["module"]) == set(state.module.state_dict())
    loaded = tckpt.load_params(path, like=init())
    assert loaded.step == 2
    state, la = step(state, images, tokens)
    loaded, lb = step(loaded, images, tokens)
    assert torch.equal(la, lb) and loaded.step == state.step == 3
    for (ka, a), (kb, b) in zip(state.module.state_dict().items(),
                                loaded.module.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    for a, b in zip(state.optimizer.state.values(), loaded.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq", "step"))


# ------------------------------------------------------------------ entry points
def test_training_entry_points_default_to_cuda(group):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


def test_make_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a default process group is up in this process")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(device_type="cpu")


def test_kernel_wrappers_refuse_autograd_on_the_card_only():
    """The guard each CUDA branch runs: grad mode on and an input that
    requires grad raise; no_grad or frozen inputs pass. CPU tensors take
    the differentiable plain versions and never reach it."""
    x = torch.ones(2, 300, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        dispatch.refuse_autograd("flash_attention", x, x.detach(), None)
    with torch.no_grad():
        dispatch.refuse_autograd("flash_attention", x, x, x)
    dispatch.refuse_autograd("flash_attention", x.detach(), None)
    from beyondff_tpu_torch.kernels import flash_attention as tfa

    tfa.attend(x, x, x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# ----------------------------------------------------------------------- mfu
def test_mfu_cost_of_a_matmul():
    """A (512, 512) @ (512, 512) matmul is exactly 2 * 512^3 FLOPs and reads
    two and writes one f32 matrix; utilization math follows from it."""
    a = torch.ones(512, 512)
    cost = mfu.program_cost(lambda x, y: x @ y, a, a)
    assert cost is not None
    assert cost.flops == 2 * 512 ** 3
    assert cost.bytes_accessed == 3 * 512 * 512 * 4
    rec = mfu.summarize("mm", cost, seconds=1e-3, device=CPU)
    assert rec["gflop"] == round(2 * 512 ** 3 / 1e9, 2)
    assert 0 < rec["mfu"] < 1 and rec["device"] == "cpu"
    line = mfu.describe("mm", cost, 1e-3, device=CPU)
    assert "MFU" in line and "bound" in line
    assert "n/a" in mfu.describe("none", None, 1.0)
    assert mfu.summarize("none", None, 1.0)["mfu"] is None
    assert mfu.program_cost(lambda x: x + 1, a) is None


def test_mfu_counts_the_backward_and_the_card_peaks(monkeypatch):
    lin = torch.nn.Linear(64, 32, bias=False)
    x = torch.ones(16, 64)
    fwd = mfu.program_cost(lambda: lin(x))
    x.requires_grad_(True)
    both = mfu.program_cost(lambda: lin(x).sum().backward())
    assert fwd.flops == 2 * 16 * 64 * 32
    assert both.flops == 3 * fwd.flops
    monkeypatch.setattr(mfu, "device_kind", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert mfu.chip_peaks() == (989e12, 3350e9)
    monkeypatch.setattr(mfu, "device_kind", lambda device=None: "some card")
    assert mfu.chip_peaks() == (1e12, 100e9)
