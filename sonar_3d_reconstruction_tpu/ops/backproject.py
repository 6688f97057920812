"""Fixed-shape tensorized sonar-ping backprojection.

Re-expresses the reference's four nested data-dependent Python loops
(scripts/3d_mapper.py:387-483, SURVEY.md section 3.2 hot loops 1-4) as one
static-shape tensor program suitable for XLA:

  * first hit       -> argmax over a boolean intensity mask with no-hit sentinel
  * free sampling   -> static grid of ceil(R/step) candidate bins + validity mask
  * occupied window -> static 50-wide window of bins gathered at first_hit + w
  * vertical fan    -> static (2*V_max+1)-wide fan with a per-range step mask

The ``int()``-truncated fan counts ``max(1, int(spread/(res*4)))`` /
``max(2, int(spread/(res*1.5)))`` (reference :427, :463) are precomputed on
the host in float64 — exact truncation parity with the NumPy reference; a
float32 device recompute can flip nv by one at truncation boundaries and move
a whole fan.  The FREE path's fan trig is static (fixed bins) and baked in as
constant tables; the OCCUPIED path's trig depends on the dynamic first-hit
bin and is computed elementwise on device (cos/sin instead of gathering
precomputed rows), using the gathered exact nv.  Beyond that the device performs only: intensity compare, first-hit
argmax, small gathers, three multiplies per point, and one batched SE(3)
transform.

Emission order inside the flattened candidate axis is (ray, free-then-occupied
bins, fan step) — irrelevant to the map result because per-frame accumulation
commutes (sum/count/max), matching reference :542-551.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np

import jax.numpy as jnp

from sonar_3d_reconstruction_tpu.config import MapperConfig


@dataclasses.dataclass(frozen=True, eq=False)
class FanTables:
    """Host-precomputed constant tables for one (config, image geometry) pair.

    Arrays are float64/ int numpy; cast to the compute dtype at trace time.
    Shapes: R = range bins, F = free candidate bins, VF/VO = fan widths.

    ``eq=False`` keeps the default identity hash/eq so an instance can be a
    jit static argument; callers cache and reuse one instance per geometry
    (models/mapper.py does) to avoid retraces.
    """

    range_bins: int
    bearing_bins: int

    # Selected ray columns and their bearing trig (n_rays,)
    ray_indices: np.ndarray
    cos_b: np.ndarray
    sin_b: np.ndarray

    # Free-space candidates, laid out as a FLAT static lattice: the fan
    # count nv(r) is static per free bin (it depends only on range), so
    # instead of a rectangular (F, VF) grid masked to |step| <= nv(r) —
    # which wastes (VF - (2nv+1)) lanes per short-range bin — each bin
    # contributes exactly its 2*nv(r)+1 fan lanes.  For the production
    # geometry this shrinks the free lattice ~43% (850 -> ~480 lanes/ray)
    # and every downstream sort/scan with it.
    free_idx: np.ndarray        # (L,) int32 absolute bin index per lane
    free_r: np.ndarray          # (L,) float range in meters per lane
    free_cos_v: np.ndarray      # (L,) fan vertical-angle cosines
    free_sin_v: np.ndarray      # (L,)
    free_mask: np.ndarray       # (L,) bool: range >= min_range

    # Occupied candidates, indexed by ABSOLUTE bin (gathered at first_hit + w).
    # Per-bin fan count nv, truncated in float64 exactly like the reference's
    # int() (:463) — the fan TRIG is computed on device, but nv must be this
    # exact integer (a float32 recompute can flip by 1 at truncation
    # boundaries, moving every point of the bin's fan).  Entry R (one past
    # the end) is a sentinel for windows that run past the image.
    occ_nv: np.ndarray          # (R+1,) int32 — EXACT, never capped
    nvo_max: int                # fan half-width sized at max_range (exact)
    # Static fan half-width actually allocated (lanes = 2*nvo_cap+1).
    # nvo_cap == nvo_max is always exact.  A SMALLER cap is a perf knob for
    # data whose returns stop short of max_range (the occupied fan at 10 m
    # needs 47 lanes, at 5 m only 23): correctness then relies on the HOST
    # gate ``required_fan_cap`` — every quantity it needs (deepest
    # above-threshold bin) is host-visible before dispatch, so no device
    # overflow flag exists; emissions for a bin with nv > nvo_cap would be
    # silently truncated.
    nvo_cap: int

    # Static FREE-lattice depth actually allocated (0 = all range bins).
    # Host-gate contract like nvo_cap/win_cap: a free bin emits only when
    # it precedes its column's first hit (reference 3d_mapper.py:419-421),
    # so bins >= the deepest first hit over the images
    # (``required_free_cap``) are statically dead; free-fan width grows
    # ~linearly with range, so the lattice cut is ~quadratic in the cap.
    free_cap: int = 0

    # Static occupied-WINDOW depth actually allocated (0 = the config's
    # full occupied_window).  Same host-gate contract as nvo_cap: the
    # reference emits a window bin only if it is itself above the intensity
    # threshold (3d_mapper.py:452), so the deepest above-threshold offset
    # past any first hit — host-visible, ``required_window_cap`` — bounds
    # the window depth these images can ever use; a return slab thinner
    # than the 50-bin worst case shrinks the occupied lattice
    # proportionally (the slab is the lattice's dominant axis).
    win_cap: int = 0

    @property
    def n_rays(self) -> int:
        return int(self.ray_indices.shape[0])

    def effective_window(self, occupied_window: int) -> int:
        w = min(occupied_window, self.range_bins)
        if self.win_cap > 0:
            w = min(w, self.win_cap)
        return max(w, 1)

    def candidates_per_ping(self, occupied_window: int = 50) -> int:
        f = self.free_idx.shape[0]
        w = self.effective_window(occupied_window)
        return self.n_rays * (f + w * (2 * self.nvo_cap + 1))


def _fan_row(
    r: float, half_ap: float, res: float, divisor: float, nv_floor: int, v_max: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One bin's vertical-fan trig row + step-validity mask (float64).

    nv = max(nv_floor, int(r*tan(half_ap) / (res*divisor)))  (reference :427/:463)
    vertical_angle(step) = step / max(1, nv) * half_ap        (reference :430/:466)
    """
    spread = r * math.tan(half_ap)
    nv = max(nv_floor, int(spread / (res * divisor)))
    steps = np.arange(-v_max, v_max + 1, dtype=np.float64)
    vang = (steps / max(1, nv)) * half_ap
    mask = np.abs(steps) <= nv
    return np.cos(vang), np.sin(vang), mask


@functools.lru_cache(maxsize=64)
def build_fan_tables(
    cfg: MapperConfig,
    range_bins: int,
    bearing_bins: int,
    fan_cap: int = 0,
    window_cap: int = 0,
    free_cap: int = 0,
) -> FanTables:
    """Precompute all static tables for this config + image geometry.

    Memoized on (cfg, geometry, fan_cap, window_cap, free_cap): FanTables
    hashes by identity (it is a jit static argument), so returning the SAME
    instance for the same inputs is what lets every caller share one
    compiled program per geometry.

    ``fan_cap`` (0 = exact worst case): static occupied-fan half-width.
    ``window_cap`` (0 = the config's occupied_window): static occupied
    window depth.  ``free_cap`` (0 = all range bins): static free-lattice
    depth.  Callers with host-visible images size them with
    ``required_fan_cap`` / ``required_window_cap`` / ``required_free_cap``
    — see the FanTables.nvo_cap / win_cap / free_cap field notes.
    """
    half_ap = cfg.half_aperture_rad
    res = cfg.voxel_resolution
    rres = cfg.max_range / range_bins  # reference :404

    # --- bearings: linspace over FOV, subsampled, FOV-gated (reference
    # :295-299, :527-535). linspace endpoints equal +-half_fov so the gate
    # passes every subsampled column, but we apply it for exactness.
    half_fov = cfg.horizontal_fov_rad / 2.0
    bearings = np.linspace(-half_fov, half_fov, bearing_bins)
    step = max(1, bearing_bins // cfg.max_rays)
    sel = np.arange(0, bearing_bins, step)
    sel = sel[np.abs(bearings[sel]) <= half_fov]

    # --- static fan widths, sized for the largest realizable range.
    # The largest range of any emitted bin is (range_bins-1)*rres < max_range,
    # which also means the reference's `range_m > max_range -> break`
    # (:458-459) can never fire; we size fans by max_range (superset, masked).
    max_spread = cfg.max_range * math.tan(half_ap)
    nvf_max = max(1, int(max_spread / (res * 4.0)))
    nvo_max = max(2, int(max_spread / (res * 1.5)))

    # --- free-space bins: every `free_sampling_step`-th bin (reference
    # :419-423), flattened to exactly 2*nv(r)+1 lanes per bin (nv is static
    # per bin, so the compaction is a host-side precomputation, not a mask)
    free_depth = range_bins if free_cap <= 0 else max(
        1, min(free_cap, range_bins)
    )
    free_bins = np.arange(0, free_depth, cfg.free_sampling_step, dtype=np.int32)
    lane_idx, lane_r, lane_cos, lane_sin, lane_mask = [], [], [], [], []
    for b in free_bins:
        r = float(b) * rres
        c, s, m = _fan_row(r, half_ap, res, 4.0, 1, nvf_max)
        keep = m  # |step| <= nv(r): drop the statically-dead lanes outright
        k = int(keep.sum())
        lane_idx.append(np.full(k, b, np.int32))
        lane_r.append(np.full(k, r, np.float64))
        lane_cos.append(c[keep])
        lane_sin.append(s[keep])
        lane_mask.append(np.full(k, r >= cfg.min_range, bool))
    free_idx = np.concatenate(lane_idx)
    free_r = np.concatenate(lane_r)
    free_cos = np.concatenate(lane_cos)
    free_sin = np.concatenate(lane_sin)
    free_mask = np.concatenate(lane_mask)

    # --- occupied per-bin fan counts, float64-truncated (reference :463);
    # entry range_bins is the sentinel for windows past the image
    occ_r_f64 = np.arange(range_bins + 1, dtype=np.float64) * rres
    occ_nv = np.maximum(
        2, (occ_r_f64 * math.tan(half_ap) / (res * 1.5)).astype(np.int64)
    ).astype(np.int32)

    nvo_cap = nvo_max if fan_cap <= 0 else max(2, min(fan_cap, nvo_max))
    win_cap = 0 if window_cap <= 0 else max(1, min(window_cap, range_bins))

    return FanTables(
        range_bins=range_bins,
        bearing_bins=bearing_bins,
        ray_indices=sel.astype(np.int32),
        cos_b=np.cos(bearings[sel]),
        sin_b=np.sin(bearings[sel]),
        free_idx=free_idx,
        free_r=free_r,
        free_cos_v=free_cos,
        free_sin_v=free_sin,
        free_mask=free_mask,
        occ_nv=occ_nv,
        nvo_max=nvo_max,
        nvo_cap=nvo_cap,
        free_cap=0 if free_depth == range_bins else free_depth,
        win_cap=win_cap,
    )


def required_fan_cap(
    images: np.ndarray, cfg: MapperConfig, range_bins: int
) -> int:
    """Exact host-side occupied-fan half-width for these images.

    The fan count of an emitting bin is ``occ_nv[bin]`` (monotone in bin),
    and only above-threshold bins emit occupied candidates, so the deepest
    above-threshold bin bounds the needed width — conservatively over all
    bearing columns (the subsampled rays are a subset) and over the whole
    occupied window (later window bins only emit if themselves above the
    threshold).  Tables built with this cap are exactly equivalent to the
    uncapped ones for these images.
    """
    images = np.asarray(images)
    hits = images > cfg.intensity_threshold
    # deepest hit bin across every ping/column (axis -2 = range rows)
    any_hit_per_bin = hits.any(axis=tuple(
        i for i in range(hits.ndim) if i != hits.ndim - 2
    ))
    if not any_hit_per_bin.any():
        return 2
    deepest = int(np.max(np.nonzero(any_hit_per_bin)[0]))
    rres = cfg.max_range / range_bins
    r = deepest * rres
    return max(2, int(r * math.tan(cfg.half_aperture_rad)
                      / (cfg.voxel_resolution * 1.5)))


def required_free_cap(
    images: np.ndarray, cfg: MapperConfig, range_bins: int
) -> int:
    """Exact host-side FREE-lattice depth for these images.

    A free-space candidate at bin b is valid only when b < first_hit of its
    column (reference 3d_mapper.py:419-421), so the deepest first hit over
    every ping/column bounds the free bins that can ever emit.  A column
    with NO hit has first_hit == range_bins (all bins free-sampled), which
    forces the full depth.  Free-fan width grows ~linearly with range, so
    the free lattice size scales ~quadratically with this cap — on surveys
    whose every column returns (e.g. continuous bottom echo) the cut is
    large.  Tables built with this cap are exactly equivalent for these
    images.  Conservative over all bearing columns (subsampled rays are a
    subset).
    """
    images = np.asarray(images)
    if images.ndim == 2:
        images = images[None]
    hits = images > cfg.intensity_threshold  # (P, R, B)
    cols_hit = hits.any(axis=-2)             # (P, B)
    if not cols_hit.all():
        return range_bins  # some column never returns: full free depth
    first = np.argmax(hits, axis=-2)         # (P, B) valid where cols_hit
    # keep free bins < max(first_hit); floor 1 keeps table shapes nonempty
    return max(1, int(first.max()))


def required_window_cap(
    images: np.ndarray, cfg: MapperConfig, range_bins: int
) -> int:
    """Exact host-side occupied-window depth for these images.

    The reference's occupied pass walks bins ``first_hit + w`` for
    w < occupied_window but emits ONLY bins above the intensity threshold
    (3d_mapper.py:449-459), so the deepest above-threshold offset past any
    column's first hit bounds the window depth these images can use.
    Conservative over every bearing column (the subsampled rays are a
    subset) and every ping; tables built with this cap are exactly
    equivalent to full-window tables for these images.  A thin return slab
    (e.g. a 12-bin bottom echo vs the 50-bin worst case) shrinks the
    occupied candidate lattice — the dominant lattice axis — by the same
    factor.
    """
    images = np.asarray(images)
    if images.ndim == 2:
        images = images[None]
    W = min(cfg.occupied_window, range_bins)
    hits = images > cfg.intensity_threshold  # (P, R, B)
    if not hits.any():
        return 1
    bins = np.arange(range_bins, dtype=np.int64)[:, None]
    deepest = 0
    for h in hits:  # per ping: keeps the (R, B) offset temp small
        cols = h.any(axis=0)
        if not cols.any():
            continue
        first = np.where(cols, np.argmax(h, axis=0), range_bins)
        off = bins - first[None, :]
        off_ok = h & (off >= 0) & (off < W)
        if off_ok.any():
            deepest = max(deepest, int(off[off_ok].max()))
    return max(1, deepest + 1)


def resolve_capped_tables(
    images: np.ndarray,
    cfg: MapperConfig,
    range_bins: int,
    bearing_bins: int,
    fan_cap="auto",
    window_cap="auto",
    free_cap="auto",
) -> FanTables:
    """Host-gated cap resolution shared by pipeline.map_ping_sequence and
    the sharded sequence wrappers: "auto" sizes each static lattice cap
    exactly for THESE images (bit-equivalent by construction); an int
    pins it; None/0 keeps the config worst case."""
    P = len(images)
    if fan_cap == "auto":
        fan_cap = required_fan_cap(images, cfg, range_bins) if P else 0
    if window_cap == "auto":
        window_cap = required_window_cap(images, cfg, range_bins) if P else 0
    if free_cap == "auto":
        free_cap = required_free_cap(images, cfg, range_bins) if P else 0
    return build_fan_tables(
        cfg, range_bins, bearing_bins, fan_cap=int(fan_cap or 0),
        window_cap=int(window_cap or 0), free_cap=int(free_cap or 0),
    )


def _local_points(r, cos_v, sin_v, cos_b, sin_b):
    """Sonar-frame coordinates (+X fwd, +Y right with the reference's negated-y
    right-hand fix, +Z down; reference :432-436).  Multiplication order matches
    the reference scalar expression ``r * cos(v) * cos(b)``."""
    rcv = r * cos_v
    x = rcv * cos_b
    y = -(rcv * sin_b)
    z = r * sin_v
    return x, y, z


def _to_world(x, y, z, T):
    """Explicit affine transform (reference :439-440 homogeneous matmul)."""
    R, t = T[:3, :3], T[:3, 3]
    wx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    wy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    wz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    return jnp.stack([wx, wy, wz], axis=-1)


def backproject_ping(
    polar_image: jnp.ndarray,
    T_sonar_to_world: jnp.ndarray,
    tables: FanTables,
    cfg: MapperConfig,
    dtype=jnp.float32,
):
    """One ping -> flattened candidate emissions (static shape).

    Args:
      polar_image: (range_bins, bearing_bins); rows are range, columns bearing
        (reference :508).
      T_sonar_to_world: (4, 4) in ``dtype``.
      tables: host-precomputed ``FanTables`` for this geometry.

    Returns dict of flattened arrays over N = n_rays*(L_free + W*VO) candidates:
      points  (N, 3) world coordinates
      log_odds (N,)  per-candidate update value
      is_occupied (N,) bool
      valid   (N,) bool
    """
    R, B = tables.range_bins, tables.bearing_bins
    assert polar_image.shape == (R, B), (polar_image.shape, (R, B))
    W = tables.effective_window(cfg.occupied_window)

    cos_b = jnp.asarray(tables.cos_b, dtype)[:, None, None]
    sin_b = jnp.asarray(tables.sin_b, dtype)[:, None, None]

    # (n_rays, R) intensity profiles, hit mask with strict > (reference :407)
    profiles = polar_image[:, jnp.asarray(tables.ray_indices)].T
    hits = profiles > cfg.intensity_threshold
    any_hit = jnp.any(hits, axis=1)
    first_hit = jnp.where(any_hit, jnp.argmax(hits, axis=1), R)  # :406-413

    T = T_sonar_to_world.astype(dtype)

    # ---- free-space candidates: (n_rays, L) flat lattice (2*nv(r)+1 lanes
    # per free bin — the fan count is static per bin, precomputed flat)
    free_r = jnp.asarray(tables.free_r, dtype)[None, :]
    fx, fy, fz = _local_points(
        free_r,
        jnp.asarray(tables.free_cos_v, dtype)[None],
        jnp.asarray(tables.free_sin_v, dtype)[None],
        cos_b[:, :, 0],
        sin_b[:, :, 0],
    )
    free_world = _to_world(fx, fy, fz, T)
    free_valid = (
        (jnp.asarray(tables.free_idx)[None, :] < first_hit[:, None])
        & jnp.asarray(tables.free_mask)[None]
    )

    # ---- occupied candidates: window bins first_hit + w (reference :449-459).
    # The per-bin fan trig depends on the DYNAMIC first-hit bin, so it is
    # computed elementwise on device instead of gathered from precomputed
    # trig rows — EXCEPT the truncated fan count nv
    # (reference :463), which is gathered from a small float64-exact host
    # table so f32 rounding can never flip it across an integer boundary.
    w_off = jnp.arange(W, dtype=jnp.int32)
    occ_bin = jnp.minimum(first_hit[:, None] + w_off[None, :], R)  # (n_rays, W)
    # ONE (n_rays, W) gather serves both the intensity gate (strict >,
    # reference :452) and the exact fan count: the per-(ray, bin) value
    # where(hit, occ_nv[bin], 0) is built elementwise (merging separate
    # bin_hit and nv gathers halves the per-window-bin indexed lanes, and
    # gathers are paid per index), with 0 doubling as the
    # not-hit sentinel (table nv is always >= 2) and the R column as the
    # past-the-image sentinel.
    hit_nv_tab = jnp.where(
        jnp.concatenate([hits, jnp.zeros((hits.shape[0], 1), bool)], axis=1),
        jnp.asarray(tables.occ_nv)[None, :],
        0,
    )
    hit_nv = jnp.take_along_axis(hit_nv_tab, occ_bin, axis=1)
    bin_hit = hit_nv > 0
    rres = cfg.max_range / R  # reference :404
    occ_r = occ_bin.astype(dtype)[:, :, None] * dtype(rres)
    half_ap = dtype(cfg.half_aperture_rad)
    # max(, 1) only guards the masked not-hit lanes' vang division (their
    # trig feeds lanes dedup discards); hit lanes keep the exact table nv
    nv = jnp.maximum(hit_nv, 1)[:, :, None]  # (n_rays, W, 1)
    nvo_cap = tables.nvo_cap  # host gate guarantees nv <= cap on emitting bins
    steps = jnp.arange(-nvo_cap, nvo_cap + 1, dtype=jnp.int32)[None, None, :]
    vang = steps.astype(dtype) / nv.astype(dtype) * half_ap  # reference :466
    occ_cos_v = jnp.cos(vang)
    occ_sin_v = jnp.sin(vang)
    step_ok = jnp.abs(steps) <= nv
    range_ok = (occ_r >= dtype(cfg.min_range)) & (
        occ_r <= dtype(cfg.max_range)
    ) & (occ_bin < R)[:, :, None]
    ox, oy, oz = _local_points(occ_r, occ_cos_v, occ_sin_v, cos_b, sin_b)
    occ_world = _to_world(ox, oy, oz, T)
    occ_valid = bin_hit[:, :, None] & step_ok & range_ok

    # ---- z filter (reference :443-444, :478-479): keep pt_world.z >= z_min
    if cfg.z_filter_enabled:
        zmin = jnp.asarray(cfg.z_filter_min, dtype)
        free_valid = free_valid & (free_world[..., 2] >= zmin)
        occ_valid = occ_valid & (occ_world[..., 2] >= zmin)

    n_free = free_world.shape[0] * free_world.shape[1]
    n_occ = occ_world.shape[0] * occ_world.shape[1] * occ_world.shape[2]
    points = jnp.concatenate(
        [free_world.reshape(n_free, 3), occ_world.reshape(n_occ, 3)], axis=0
    )
    valid = jnp.concatenate(
        [free_valid.reshape(n_free), occ_valid.reshape(n_occ)], axis=0
    )
    is_occ = jnp.concatenate(
        [jnp.zeros(n_free, bool), jnp.ones(n_occ, bool)], axis=0
    )
    log_odds = jnp.where(
        is_occ,
        jnp.asarray(cfg.log_odds_occupied, dtype),
        jnp.asarray(cfg.log_odds_free, dtype),
    )
    return {
        "points": points,
        "log_odds": log_odds,
        "is_occupied": is_occ,
        "valid": valid,
    }
