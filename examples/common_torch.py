"""What the port's examples share: predictors of graded cost (the paper's
Fig 3 spectrum: linear SVM .. RBF kernel SVM), a synthetic task, quickly
trained linear models, and a batch timer.

The port's own copy of the helpers that ``examples/*.py`` take from
``benchmarks/common.py``, in PyTorch. Every function that touches a tensor
takes an explicit ``device``. The weights are drawn from the caller's numpy
``rng`` in the reference's order and scales and cast to float32 as
``jnp.asarray`` casts them, so they are bit-equal to the reference's; the
predictors are plain eager PyTorch (fp32 products, TF32 left off)."""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

D_FEAT = 64
N_CLASSES = 10


def _tensor(a, device) -> torch.Tensor:
    """Host array -> tensor on ``device``, float64 cast to float32 as
    ``jnp.asarray`` casts it (64-bit mode off)."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _sync(device) -> None:
    """Wait for the device's queued work (the counterpart of
    ``block_until_ready``); the CPU runs eagerly."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_containers(rng: np.random.Generator,
                    device) -> Dict[str, Callable]:
    """Predictors spanning ~3 orders of magnitude of cost (paper Fig 3's
    model spectrum): tensor [b, D_FEAT] on ``device`` -> [b, N_CLASSES]."""
    def draw(shape, scale=None):
        a = rng.normal(size=shape)
        return _tensor(a if scale is None else a * scale, device)

    w_lin = draw((D_FEAT, N_CLASSES), 0.1)
    w1 = draw((D_FEAT, 512), 0.1)
    w2 = draw((512, N_CLASSES), 0.1)
    wb1 = draw((D_FEAT, 2048), 0.1)
    wb2 = draw((2048, 2048), 0.1)
    wb3 = draw((2048, N_CLASSES), 0.1)
    support = draw((4096, D_FEAT))
    alpha = draw((4096, N_CLASSES), 0.01)

    def linear_svm(x):
        return x @ w_lin

    def mlp(x):
        return torch.relu(x @ w1) @ w2

    def big_mlp(x):
        return torch.relu(torch.relu(x @ wb1) @ wb2) @ wb3

    def kernel_svm(x):
        d2 = ((x[:, None, :] - support[None, :, :]) ** 2).sum(-1)
        return torch.exp(-0.01 * d2) @ alpha

    def noop(x):
        return x[:, :N_CLASSES]

    return {"linear_svm": linear_svm, "mlp": mlp, "big_mlp": big_mlp,
            "kernel_svm": kernel_svm, "noop": noop}


def np_call(fn: Callable, device) -> Callable:
    """Host numpy in, ``fn`` on ``device``, host numpy out."""
    return lambda x: fn(_tensor(x, device)).cpu().numpy()


def time_batch(fn: Callable, x: np.ndarray, iters: int = 5, *,
               device) -> float:
    """Median wall-clock seconds for one batched call (post-warmup). The
    input is copied to ``device`` before the window; each timed call ends
    when the device has finished it."""
    xt = _tensor(x, device)
    fn(xt)
    _sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(xt)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def fit_linear_latency(fn: Callable, rng, sizes=(1, 4, 16, 64, 256), *,
                       device) -> Tuple[float, float]:
    """Measure the latency profile, return (base_s, per_item_s)."""
    xs, ys = [], []
    for b in sizes:
        x = rng.normal(size=(b, D_FEAT)).astype(np.float32)
        xs.append(b)
        ys.append(time_batch(fn, x, device=device))
    a = float(np.cov(xs, ys, bias=True)[0, 1] / np.var(xs))
    b0 = float(np.median(np.asarray(ys) - a * np.asarray(xs)))
    return max(b0, 1e-6), max(a, 1e-9)


# ---------------------------------------------------------------------------
# synthetic classification task + quickly-trained models (Figs 7/8/10)
# ---------------------------------------------------------------------------

def make_task(rng, d=D_FEAT, k=N_CLASSES):
    W = rng.normal(size=(d, k)).astype(np.float32)

    def label(x: np.ndarray) -> np.ndarray:
        return np.argmax(x @ W, axis=-1)

    return W, label


def train_linear_model(rng, W_true, *, noise: float, n_train: int = 2000,
                       steps: int = 60, feature_mask: np.ndarray = None,
                       device) -> Callable:
    """Train a linear softmax model on noisy data — graded model quality.
    Full-batch gradient descent (lr 0.5) of the mean softmax cross-entropy
    on ``device``; draws from ``rng`` exactly what the reference draws."""
    d, k = W_true.shape
    X = rng.normal(size=(n_train, d)).astype(np.float32)
    y = np.argmax(X @ W_true, axis=-1)
    flip = rng.random(n_train) < noise
    y = np.where(flip, rng.integers(0, k, n_train), y)
    mask = np.ones(d, np.float32) if feature_mask is None else feature_mask
    Xt = _tensor(X * mask, device)
    yt = torch.from_numpy(y).to(device)
    rows = torch.arange(len(y), device=device)

    def loss(w):
        logits = Xt @ w
        return -torch.log_softmax(logits, dim=-1)[rows, yt].mean()

    w = torch.zeros((d, k), device=device)
    lr = 0.5
    with torch.enable_grad():
        for _ in range(steps):
            w.requires_grad_(True)
            (g,) = torch.autograd.grad(loss(w), w)
            w = (w - lr * g).detach()
    mask_t = _tensor(mask, device)

    def predict(x):
        return torch.softmax((x * mask_t) @ w, dim=-1)

    return predict
