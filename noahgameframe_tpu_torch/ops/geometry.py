"""Batched geometry helpers (vectors, rays, spheres, planes, AABBs).

Counterpart of ``noahgameframe_tpu/ops/geometry.py`` (reference
NFVector2/3, NFMath and the NFLine/NFPlane/NFRay/NFSphere/NFBox headers,
SURVEY §2.1).  Every helper is a tensor function over ``[..., 2|3]``
coordinates, so one call tests N rays against N spheres on the device.

Each helper rounds as the JAX function does when called op by op: every
operation rounds once, and square roots are correctly rounded
(``core/rounding.sqrt32``).  (Inside a compiled caller XLA may contract
``a*b + c`` into fused multiply-adds; the helpers have no such caller.)

Conventions: rays are (origin, direction) with unnormalized directions
allowed; "t" parameters are in units of the direction vector; misses
return t = inf so a downstream ``torch.where(hit, ...)`` stays
branch-free.  Scalars (``t``, radii, plane offsets) may be Python numbers
or tensors.
"""

from __future__ import annotations

import math

import torch

from ..core.rounding import sqrt32

_EPS = 1e-12
INF = math.inf


def _t(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# ------------------------------------------------------------------ vectors
def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return sqrt32(torch.clamp(dot(v, v), min=0.0))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Zero vectors normalize to zero (no NaNs)."""
    n = length(v)
    return torch.where(n[..., None] > _EPS, v / torch.clamp(n, min=_EPS)[..., None],
                       torch.zeros((), dtype=v.dtype, device=v.device))


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return length(a - b)


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    return a + (b - a) * _t(t, a)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b)


# -------------------------------------------------------------------- rays
def ray_point(origin: torch.Tensor, direction: torch.Tensor, t) -> torch.Tensor:
    return origin + direction * _t(t, origin)[..., None]


def ray_sphere(origin: torch.Tensor, direction: torch.Tensor, center: torch.Tensor,
               radius) -> torch.Tensor:
    """First intersection t >= 0 of ray(s) with sphere(s); inf on miss.
    Rays starting inside hit at the exit point."""
    radius = _t(radius, origin)
    oc = origin - center
    a = dot(direction, direction)
    b = 2.0 * dot(oc, direction)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = sqrt32(torch.clamp(disc, min=0.0))
    a2 = torch.clamp(2.0 * a, min=_EPS)
    t0 = (-b - sq) / a2
    t1 = (-b + sq) / a2
    t = torch.where(t0 >= 0.0, t0, t1)
    # a degenerate (zero-direction) ray hits only if it STARTS inside
    ok = torch.where(a > _EPS, (disc >= 0.0) & (t >= 0.0), c <= 0.0)
    return torch.where(ok, torch.where(a > _EPS, t, 0.0), INF)


def ray_plane(origin: torch.Tensor, direction: torch.Tensor, normal: torch.Tensor,
              plane_d) -> torch.Tensor:
    """t of a ray against the plane dot(n, x) + d = 0; inf when parallel
    or behind the origin."""
    plane_d = _t(plane_d, origin)
    denom = dot(direction, normal)
    par = torch.abs(denom) > _EPS
    t = -(dot(origin, normal) + plane_d) / torch.where(par, denom, _EPS)
    return torch.where(par & (t >= 0.0), t, INF)


def ray_aabb(origin: torch.Tensor, direction: torch.Tensor, box_min: torch.Tensor,
             box_max: torch.Tensor) -> torch.Tensor:
    """Slab test: entry t (0 when starting inside); inf on miss."""
    inv = 1.0 / torch.where(torch.abs(direction) > _EPS, direction, _EPS)
    t1 = (box_min - origin) * inv
    t2 = (box_max - origin) * inv
    t_near = torch.amax(torch.minimum(t1, t2), dim=-1)
    t_far = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = t_far >= torch.clamp(t_near, min=0.0)
    return torch.where(hit, torch.clamp(t_near, min=0.0), INF)


# ----------------------------------------------------------------- queries
def point_in_aabb(p: torch.Tensor, box_min: torch.Tensor,
                  box_max: torch.Tensor) -> torch.Tensor:
    return torch.all((p >= box_min) & (p <= box_max), dim=-1)


def sphere_overlap(ca: torch.Tensor, ra, cb: torch.Tensor, rb) -> torch.Tensor:
    ra, rb = _t(ra, ca), _t(rb, ca)
    d2 = dot(ca - cb, ca - cb)
    r = ra + rb
    return d2 <= r * r


def segment_point_distance(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Distance from point(s) p to segment(s) ab."""
    ab = b - a
    t = dot(p - a, ab) / torch.clamp(dot(ab, ab), min=_EPS)
    t = torch.clamp(t, 0.0, 1.0)
    return length(p - (a + ab * t[..., None]))
