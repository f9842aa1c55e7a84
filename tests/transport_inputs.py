"""Seeded inputs shared by the transport tests (tests/test_torch_transports.py
against the JAX package, tests/test_torch_transports_card.py on the card):
natural-like frames and depth maps, JPEG files of several layouts, crop
boxes. Imports no JAX."""

import numpy as np
import cv2


def structured(h, w, seed=0):
    """Natural-image-like content (smooth fields, rectangles, mild noise):
    JXT takes it; uniform noise would spill."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 60 * np.sin(xx / 40 + seed) + 40 * np.cos(yy / 30)
    img = np.stack([base, base * 0.9 + 10, base * 0.8 + 20], -1)
    for _ in range(8):
        x0, y0 = rng.integers(0, max(w - 20, 1)), rng.integers(0, max(h - 20, 1))
        dw, dh = rng.integers(10, w // 2), rng.integers(10, h // 2)
        img[y0:y0 + dh, x0:x0 + dw] = (
            0.7 * img[y0:y0 + dh, x0:x0 + dw] + 0.3 * rng.integers(30, 220, 3))
    img = img + rng.normal(0, 2, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg(img_rgb, quality=90, **flags):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    for k, v in flags.items():
        params += [getattr(cv2, k), v]
    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR)
                           if img_rgb.ndim == 3 else img_rgb, params)
    assert ok
    return enc.tobytes()


def smooth_depth(h, w, seed=0):
    """Indoor-like depth in mm: smooth surfaces, box edges, zero speckle."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 2000 + 800 * np.sin(xx / 37.0) + 500 * (yy / h)
    for _ in range(6):
        x0, y0 = rng.integers(0, w - 20), rng.integers(0, h - 20)
        dw, dh = rng.integers(10, w // 2), rng.integers(10, h // 2)
        d[y0:y0 + dh, x0:x0 + dw] = 1200 + 100 * np.sin(xx[y0:y0 + dh, x0:x0 + dw] / 11.0)
    d = d + rng.integers(-3, 4, (h, w))
    d[rng.random((h, w)) < 0.02] = 0
    return np.clip(d, 0, 65535).astype(np.uint16)

def jxt_cases():
    gray = cv2.cvtColor(structured(96, 128, seed=5), cv2.COLOR_RGB2GRAY)
    return {
        "420_q90": jpeg(structured(96, 128, seed=1), 90),
        "420_odd_q95": jpeg(structured(97, 131, seed=2), 95),
        "444": jpeg(structured(96, 128, seed=3), 90,
                     IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "gray": jpeg(gray, 90),
    }

def depth_cases():
    rng = np.random.default_rng(3)
    edges = smooth_depth(120, 160, seed=9).astype(np.int64)
    edges[40:80, 30:90] = 65000  # jumps that escape, both signs
    edges[rng.random(edges.shape) < 0.01] = 0
    return {"smooth": smooth_depth(120, 160), "odd_size": smooth_depth(67, 93, seed=3),
            "edges_escapes": edges.astype(np.uint16),
            "constant": np.full((64, 96), 1234, np.uint16),
            "gradient": (np.arange(80 * 96).reshape(80, 96) % 4096).astype(np.uint16)}

def crop_inputs(rng, b=3, h=96, w=128, k=40):
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    frame_of = rng.integers(0, b, k)
    xy0 = rng.uniform(-10, 100, (k, 2))
    boxes = (np.concatenate([xy0, xy0 + rng.uniform(-5, 80, (k, 2))], 1) * 2).astype(np.float32)
    return frames, frame_of, boxes, rng.random(k) < 0.9, (2 * h, 2 * w)
