"""Per-observer interest queries and quantized positions, on the device.

Counterpart of ``noahgameframe_tpu/ops/interest.py``.  The reference's
group-granular broadcast (NFCSceneAOIModule: every player in the (scene,
group) sees every change there, NFCSceneAOIModule.cpp:531-593) fans a busy
group out to the whole world; this module computes per-session visible
sets instead:

1. :func:`quantize`: u16-quantized positions over the scene extent, with
   out-of-extent rows masked out (not clamped onto the edge).
2. :func:`visible_candidates`: bin the moved entities into the stencil
   engine's cell table (ops/stencil.build_cell_table) and, for every
   observer, read its 3x3 neighbourhood's K slots and mask them by
   distance and broadcast scope: ``[S, 9K]`` candidate rows in one pass.
   :func:`visible_candidates_cached` bins through a Verlet cache
   (ops/verlet.py) instead of a sort.

Rounding follows the reference's compiled callers (core/rounding.py):
``obs / cell_size`` is ``obs * float32(1/cell_size)``, the squared
distance is ``fma(dx, dx, dy*dy)``, and the quantizer rounds half to even.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .aoi import _r2, sq_dist
from .stencil import STENCIL, CellTable, build_cell_table
from .verlet import VerletCache, refresh, sub_table

QMAX = 65535  # u16 quantization range


class InterestResult(NamedTuple):
    rows: torch.Tensor  # [S, 9K] int32 entity row ids (garbage where ~ok)
    ok: torch.Tensor  # [S, 9K] bool: occupied slot AND within radius AND in scope


def quantize(pos: torch.Tensor, alive: torch.Tensor,
             extent: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q [C, 3] int32, in_extent [C] bool).  The stream covers [0, extent]
    per axis; rows outside it are excluded through the mask, not clamped
    onto the boundary.  Only X and Y gate: Z is client-supplied jitter."""
    p3 = pos[:, :3] if pos.shape[1] >= 3 else F.pad(pos, (0, 3 - pos.shape[1]))
    xy = p3[:, :2]
    in_extent = torch.all((xy >= 0.0) & (xy <= float(np.float32(extent))), dim=-1) & alive
    scale = float(np.float32(QMAX / float(extent)))
    q = torch.clamp(torch.round(p3 * scale), 0, QMAX).to(torch.int32)
    return q, in_extent


def scope_mask(cand_scene, cand_group, obs_scene, obs_group) -> torch.Tensor:
    """The reference's broadcast visibility scope (NFCSceneAOIModule):
    same scene, and either the same group or the candidate carries
    GroupID 0 (scene-wide wildcard).  All args are broadcastable f32
    tensors.  The fused kernel (csrc/stencil.cu) applies the same rule to
    its AOI occupancy count."""
    return (cand_scene == obs_scene) & ((cand_group == 0) | (cand_group == obs_group))


def _interest_feats(pos: torch.Tensor, scene: torch.Tensor,
                    group: torch.Tensor) -> torch.Tensor:
    """The candidate feature layout both builders share: row id, x, y,
    scene, group (the table builder appends occupancy)."""
    n = pos.shape[0]
    return torch.cat([
        torch.arange(n, dtype=torch.float32, device=pos.device)[:, None],
        pos[:, :2].to(torch.float32),
        scene.to(torch.float32)[:, None],
        group.to(torch.float32)[:, None],
    ], dim=1)


def _scan_observers(table: CellTable, obs_pos: torch.Tensor, obs_scene: torch.Tensor,
                    obs_group: torch.Tensor, radius: float,
                    cell_size: float) -> InterestResult:
    """The per-observer 3x3 read shared by the fresh and cached builders:
    observers index by their current cell, candidates mask by the true
    radius on the current positions carried in the payload, which keeps
    anchor-binned (cached) tables exact while cell_size >= radius +
    skin/2 covers the staleness."""
    grid = table.grid_view()  # [H, W, K, F+1]
    h, w = grid.shape[:2]
    inv = float(np.float32(1.0 / cell_size))
    ox = torch.floor(obs_pos[:, 0] * inv).to(torch.int32)
    oy = torch.floor(obs_pos[:, 1] * inv).to(torch.int32)
    r2 = _r2(radius)
    rows, oks = [], []
    for dy, dx in STENCIL:
        yy, xx = oy + dy, ox + dx
        in_grid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        cells = grid[yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]  # [S, K, F+1]
        occ = (cells[..., -1] > 0) & in_grid[:, None]
        within = sq_dist(cells[..., 1] - obs_pos[:, None, 0],
                         cells[..., 2] - obs_pos[:, None, 1]) <= r2
        scoped = scope_mask(cells[..., 3], cells[..., 4],
                            obs_scene[:, None], obs_group[:, None])
        rows.append(cells[..., 0].to(torch.int32))
        oks.append(occ & within & scoped)
    return InterestResult(rows=torch.cat(rows, dim=1), ok=torch.cat(oks, dim=1))


def visible_candidates(pos: torch.Tensor, moved: torch.Tensor, scene: torch.Tensor,
                       group: torch.Tensor, obs_pos: torch.Tensor, obs_scene: torch.Tensor,
                       obs_group: torch.Tensor, radius: float, cell_size: float,
                       width: int, bucket: int) -> InterestResult:
    """For each observer, the moved entities within ``radius`` and in its
    broadcast scope (same scene; the same group, or the entity carries
    GroupID 0).  ``cell_size`` must be >= radius so the 3x3 stencil covers
    the disc; entities beyond a cell's ``bucket`` slots are dropped for
    the frame."""
    feats = _interest_feats(pos, scene, group)
    table = build_cell_table(pos, moved, feats, cell_size, width, bucket)
    return _scan_observers(table, obs_pos, obs_scene, obs_group, radius, cell_size)


def visible_candidates_cached(
    cache: VerletCache, pos: torch.Tensor, moved: torch.Tensor, alive: torch.Tensor,
    scene: torch.Tensor, group: torch.Tensor, obs_pos: torch.Tensor,
    obs_scene: torch.Tensor, obs_group: torch.Tensor, radius: float, cell_size: float,
    width: int, bucket: int, skin: float,
) -> Tuple[InterestResult, VerletCache, torch.Tensor]:
    """:func:`visible_candidates` over a Verlet-cached binning: the cache
    anchors the whole alive population, and each frame's ``moved`` subset
    rides a sub-table through the cached order.  ``cell_size`` must be >=
    radius + skin.  Returns (result, new_cache, rebuilt); thread the cache
    into the next frame."""
    # anchored on the stable alive set: anchoring on `moved` would flip
    # the active mask, and force a rebuild, every frame
    cache, rebuilt = refresh(cache, pos, alive, cell_size, width, bucket, skin)
    feats = _interest_feats(pos, scene, group)
    table = sub_table(cache, moved & alive, feats, width * width, cell_size, width, bucket)
    result = _scan_observers(table, obs_pos, obs_scene, obs_group, radius, cell_size)
    return result, cache, rebuilt
