"""UCR-like series made on the device, vectorised.

The same recipe as the port's host generator (``data/synthetic.py``):
per-class prototypes from a smoothed random walk, instances that are
monotone knot warps of their class prototype, amplitude jitter, additive
noise and z-normalisation.  Rewritten for the device in a few large
calls, because the host loop takes minutes at 2^20 series.  The same
generator (device and seed) gives the same tensors.
"""

from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# rows per call, so a 2^20-row store makes no (N, L) temporary larger
# than a few hundred MB
_CHUNK_ROWS = 1 << 17
_KNOTS = 6


def stream_seed(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose of one run (``("store",)``,
    ``("batch", 3)``, ...), so streams never overlap."""
    text = repr((int(seed),) + tuple(purpose)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(seed: int, *purpose, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, *purpose))
    return g


def znorm(x: Tensor) -> Tensor:
    """Row-wise z-normalisation (population std, 1e-8 floor)."""
    mu = x.mean(-1, keepdim=True)
    sd = x.std(-1, keepdim=True, unbiased=False)
    return (x - mu) / (sd + 1e-8)


def prototypes(n_classes: int, length: int, g: torch.Generator,
               device) -> Tensor:
    """``(C, L)`` z-normalised smoothed random walks (box filter of 9)."""
    walk = torch.randn((n_classes, length + 16), generator=g,
                       device=device).cumsum(-1)
    ker = torch.full((1, 1, 9), 1.0 / 9, device=device)
    smooth = F.conv1d(walk[:, None], ker, padding=4)[:, 0]
    return znorm(smooth[:, 8:8 + length])


def _interp_rows(u: Tensor, ys: Tensor) -> Tensor:
    """Piecewise-linear interpolation of ``ys`` ((R, K) values at K
    equispaced knots on [0, 1]) at ``u`` ((L,) points in [0, 1])."""
    K = ys.shape[1]
    pos = u * (K - 1)
    seg = pos.floor().clamp(max=K - 2).long()
    frac = pos - seg
    y0 = ys[:, seg]
    return y0 + (ys[:, seg + 1] - y0) * frac


def instances(protos: Tensor, labels: Tensor, g: torch.Generator, *,
              warp: float, noise: float, amp: float) -> Tensor:
    """``(R, L)`` warped, jittered, noisy, z-normalised copies of the
    prototypes of ``labels``: one row per label, made in chunks."""
    R = labels.shape[0]
    L = protos.shape[1]
    dev = protos.device
    u = torch.linspace(0.0, 1.0, L, device=dev)
    out = torch.empty((R, L), dtype=torch.float32, device=dev)
    for s in range(0, R, _CHUNK_ROWS):
        e = min(s + _CHUNK_ROWS, R)
        n = e - s
        knots = torch.linspace(0.0, 1.0, _KNOTS, device=dev).expand(n, -1)
        ky = knots + torch.randn((n, _KNOTS), generator=g, device=dev) \
            * (warp / _KNOTS)
        ky[:, 0] = 0.0
        ky[:, -1] = 1.0
        ky = torch.cummax(ky, dim=1).values
        ky = ky / ky[:, -1:].clamp(min=1e-9)
        t = _interp_rows(u, ky) * (L - 1)             # warped time, (n, L)
        i0 = t.floor().clamp(max=L - 2).long()
        frac = t - i0
        p = protos[labels[s:e]]                       # (n, L)
        x0 = p.gather(1, i0)
        x = x0 + (p.gather(1, i0 + 1) - x0) * frac
        scale = 1.0 + amp * torch.randn((n, 1), generator=g, device=dev)
        x = x * scale + noise * torch.randn((n, L), generator=g, device=dev)
        out[s:e] = znorm(x)
    return out


def make_store(cfg: dict, seed: int, device) -> tuple[Tensor, Tensor, Tensor]:
    """``(protos, series, labels)`` of a configuration: the prototypes
    from the configuration's ``data_seed``, the store's labels and
    instances from the run's ``seed``."""
    gp = generator(cfg["data_seed"], "prototypes", device=device)
    protos = prototypes(cfg["n_classes"], cfg["length"], gp, device)
    g = generator(seed, "store", device=device)
    labels = torch.randint(0, cfg["n_classes"], (cfg["n_store"],),
                           generator=g, device=device)
    series = instances(protos, labels, g, warp=cfg["warp"],
                       noise=cfg["noise"], amp=cfg["amp_jitter"])
    return protos, series, labels.to(torch.int32)
