"""Plain float32 reference of NPVP's sliding-window future prediction, for
horizons beyond the predictor's ``max_T``, on the modules of
``reference/model.py``.

The rollout is written from its rule: window w observes the last P frames
(the observed clip in window 0, then the newest decoded frames) at times
re-based to 0..P−1, predicts the ``max_T − P`` frames at times P..max_T−1
through AE encode, the predictor with the prior sample ``eps[w]`` and AE
decode, and hands its decoded frames on as the next window's context; the
surplus frames of the last window are dropped. Clips are independent
(every norm of the served model uses frozen statistics), so a batch is
computed in blocks of clips that fit the device, each block through all
of its windows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from npvp_bench.reference.model import coordinate_grid


def rollout(ae, pred, frames: torch.Tensor, num_future: int,
            eps: Optional[Sequence[torch.Tensor]], max_T: int, max_H: int,
            max_W: int, block: Optional[int] = None) -> torch.Tensor:
    """frames (N, P, H, W, C) observed at 0..P−1 → (N, num_future, H, W,
    C), the frames at P..P+num_future−1; ``eps`` one (N, max_H, max_W,
    embed_dim) prior sample a window (None for NPVP-D); ``block`` clips at
    a time (all of them by default)."""
    N, P = frames.shape[:2]
    chunk = max_T - P
    if chunk <= 0:
        raise ValueError(f"context of {P} frames leaves no target time "
                         f"under max_T={max_T}")
    windows = -(-num_future // chunk)
    oc = coordinate_grid(range(P), max_T, max_H, max_W, frames.device)
    tc = coordinate_grid(range(P, max_T), max_T, max_H, max_W,
                         frames.device)
    block = block or N
    out = []
    for s in range(0, N, block):
        context = frames[s:s + block]
        preds = []
        for w in range(windows):
            e = None if eps is None else eps[w][s:s + block]
            feats = pred(ae.encode(context), oc, tc, e).pred_features
            preds.append(ae.decode(feats))
            context = torch.cat([context, preds[-1]], dim=1)[:, -P:]
        out.append(torch.cat(preds, dim=1)[:, :num_future])
    return torch.cat(out)
