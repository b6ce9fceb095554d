"""Continuous (t, h, w) coordinate grids (port of
``npvp_tpu/models/coords.py``).

Coordinates are normalised to [0, 1] by the maxima and laid out as a
``(T*H*W, 3)`` grid in (t, h, w) order. A task is only a choice of time
lists, so fractional times (HVRC) are plain data.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_bounds(name: str, values, max_value: float) -> None:
    """Reject coordinates outside [0, max]: out-of-range times fall outside
    the trained Fourier-feature range (the reference asserts the same)."""
    vals = (values.detach().cpu().numpy() if torch.is_tensor(values)
            else np.asarray(values))
    if vals.size and (vals.min() < 0.0 or vals.max() > max_value):
        raise ValueError(
            f"{name} coordinates must lie in [0, {max_value}]; got "
            f"[{vals.min()}, {vals.max()}]. Future prediction beyond max_T "
            "takes the sliding-window protocol (VideoPredictor.vfp).")


def coordinate_grid(t_list, h_list, w_list, max_T: float, max_H: float,
                    max_W: float, device="cpu") -> torch.Tensor:
    """(T*H*W, 3) float32 grid of normalised (t, h, w) coordinates."""
    _check_bounds("t", t_list, max_T)
    _check_bounds("h", h_list, max_H)
    _check_bounds("w", w_list, max_W)
    as_t = lambda v, m: (torch.as_tensor(np.asarray(  # noqa: E731
        v.detach().cpu() if torch.is_tensor(v) else v, np.float32))
        / np.float32(m))
    t, h, w = as_t(t_list, max_T), as_t(h_list, max_H), as_t(w_list, max_W)
    T, H, W = t.shape[0], h.shape[0], w.shape[0]
    grid = torch.stack([t[:, None, None].expand(T, H, W),
                        h[None, :, None].expand(T, H, W),
                        w[None, None, :].expand(T, H, W)], dim=-1)
    return grid.reshape(T * H * W, 3).to(device)


def spatial_index_lists(max_H: int, max_W: int):
    """The full-resolution h/w index lists."""
    return (np.arange(max_H, dtype=np.float32),
            np.arange(max_W, dtype=np.float32))


def task_time_lists(task: str, num_past: int, num_future: int,
                    context_p: int = 0, context_f: int = 0):
    """Observed/target time index lists of the canonical tasks.

    VFP: observe [0, P), predict [P, P+F); VPE: observe [F, F+P), predict
    [0, F); VFI: observe both ends, predict the middle."""
    total = num_past + num_future
    idx = np.arange(total, dtype=np.float32)
    if task == "VFP":
        return idx[:num_past], idx[num_past:]
    if task == "VPE":
        return idx[num_future:], idx[:num_future]
    if task == "VFI":
        to = np.concatenate([idx[:context_p], idx[total - context_f:]])
        return to, idx[context_p: total - context_f]
    raise ValueError(f"unknown task {task!r}; expected VFP | VPE | VFI")


def full_coordinate_volume(max_T: int, max_H: int, max_W: int,
                           device="cpu") -> torch.Tensor:
    """(max_T·max_H·max_W, 3) grid of every integer coordinate: the
    observed and target grids of the masked (rand-context) mode."""
    h, w = spatial_index_lists(max_H, max_W)
    return coordinate_grid(np.arange(max_T, dtype=np.float32), h, w, max_T,
                           max_H, max_W, device=device)
