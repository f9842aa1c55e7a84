"""The transports' device decodes on the card against their CPU results.

Run on a machine with an NVIDIA GPU (no JAX needed):
``python -m pytest --noconftest -m cuda tests/test_torch_transports_card.py``.
Depth-pack is held bit for bit; the YCrCb unpack, the JXT decode and its
resize and the device CLIP crops within one level on at most 1e-4 of the
values (float32 contractions, which cuBLAS and the CPU sum in different
orders). Every test skips without a card.
"""

import numpy as np
import pytest
import torch

from beyondff_tpu_torch.core import color, crop_resize, depth_pack, jxt
from beyondff_tpu_torch.models.gdino.model import IMAGE_MEAN, IMAGE_STD
from transport_inputs import crop_inputs, depth_cases, jxt_cases, structured

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest --noconftest -m cuda tests/test_torch_transports_card.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _levels_close(got, want):
    d = (got.cpu().to(torch.int64) - want.to(torch.int64)).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(depth_cases()))
def test_depth_pack_decode_on_the_card(cuda_device, name):
    pk = depth_pack.pack(depth_cases()[name])
    got = depth_pack.upload_frames([pk, pk], cuda_device)
    assert torch.equal(got.cpu(), depth_pack.upload_frames([pk, pk], CPU))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(97, 131), (968, 1296)])
def test_ycrcb_unpack_on_the_card(cuda_device, hw):
    imgs = [structured(*hw, seed=s) for s in range(2)]
    _levels_close(color.upload_frames(imgs, cuda_device), color.upload_frames(imgs, CPU))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(jxt_cases()))
def test_jxt_decode_and_resize_on_the_card(cuda_device, name):
    pk = jxt.pack_file(jxt_cases()[name])
    got = jxt.upload_frame(pk, cuda_device)
    want = jxt.upload_frame(pk, CPU)
    _levels_close(got, want)
    _levels_close(jxt.resize_frame(got, (48, 64)), jxt.resize_frame(want, (48, 64)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["yolo", "gdino"])
def test_device_crops_on_the_card(cuda_device, mode):
    frames, frame_of, boxes, valid, frame_hw = crop_inputs(np.random.default_rng(0))
    kw = dict(det_hw=(80, 100), mean=IMAGE_MEAN, std=IMAGE_STD) if mode == "gdino" else {}
    got = crop_resize.clip_crop_batch(torch.from_numpy(frames).to(cuda_device), frame_of, boxes,
                                      valid, mode, frame_hw, n=56, **kw)
    want = crop_resize.clip_crop_batch(torch.from_numpy(frames), frame_of, boxes, valid, mode,
                                       frame_hw, n=56, **kw)
    _levels_close(got, want)
