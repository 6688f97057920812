"""Voxel-key packing: (kx, ky, kz) int32 triples <-> two uint32 words.

Integer voxel keys (floor(world/resolution), reference 3d_mapper.py:63-66)
are packed into a 60-bit code split over two uint32s so that

  * lexicographic order of (hi, lo) equals lexicographic order of the
    biased (kx, ky, kz) triple — a two-key ``jax.lax.sort`` groups equal
    voxels (the per-frame dedup in ops/dedup.py), and
  * per-key table ops touch 2 scalar words instead of 3-wide rows.

Each axis gets 20 bits, biased by 2^19: representable keys are
[-2^19, 2^19 - 1] per axis — ±26 km of world extent at 5 cm resolution.
Keys outside that range are reported so callers can poison the frame
(the reference's dict has no such limit; in practice survey extents are
hundreds of meters).

The all-ones ``hi`` word is reserved: EMPTY_HI marks empty table slots and
invalid candidates (it sorts after every valid key).  A valid key cannot
produce it because hi's low 12 bits come from y's HIGH bits only when x's
20 bits are also all-ones — excluded by capping the valid x range at
2^19 - 2 (dropping the single outermost x-plane of the 52 km cube — a
conservative carve-out; a corner-only exclusion would NOT be safe, since
any x = all-ones key with all-ones high y bits collides with EMPTY_HI).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax.numpy as jnp

AXIS_BITS = 20
_BIAS = 1 << (AXIS_BITS - 1)          # 2^19
_AXIS_MAX = (1 << AXIS_BITS) - 1       # biased upper bound (inclusive)

# np (not jnp) scalars: a module-level jnp constant would initialize the
# jax backend at IMPORT time (importing the library must not choose or
# reserve a device).  Inside traced code numpy scalars lift to identical
# uint32 constants.
EMPTY_HI = np.uint32(0xFFFFFFFF)

# hi = x20 << 12 | y20 >> 8      (x's 20 bits, y's high 12 bits)
# lo = (y20 & 0xFF) << 20 | z20  (y's low 8 bits, z's 20 bits; bits 28-31 zero)


def pack_keys(keys: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(N, 3) int32 voxel keys -> (hi (N,), lo (N,), in_range (N,)) uint32/bool.

    Out-of-range keys still produce a (meaningless) code; callers must mask
    with ``in_range``.
    """
    b = keys + jnp.int32(_BIAS)
    in_range = jnp.all((b >= 0) & (b <= _AXIS_MAX), axis=-1)
    # exclude the single all-ones-x corner so hi == EMPTY_HI is unreachable
    in_range = in_range & (b[..., 0] < _AXIS_MAX)
    x, y, z = b[..., 0].astype(jnp.uint32), b[..., 1].astype(jnp.uint32), b[..., 2].astype(jnp.uint32)
    hi = (x << 12) | (y >> 8)
    lo = ((y & jnp.uint32(0xFF)) << 20) | z
    return hi, lo, in_range


def unpack_keys(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    """Inverse of pack_keys -> (N, 3) int32 (undefined for EMPTY_HI)."""
    x = (hi >> 12).astype(jnp.int32)
    y = (((hi & jnp.uint32(0xFFF)) << 8) | (lo >> 20)).astype(jnp.int32)
    z = (lo & jnp.uint32(0xFFFFF)).astype(jnp.int32)
    return jnp.stack([x, y, z], axis=-1) - jnp.int32(_BIAS)


# ---------------------------------------------------------------------------
# Brick-aware packing (grid/brick.py sparse-of-dense experiment).
#
# Voxel keys are split into a BRICK coordinate (key >> brick_bits per axis)
# and an in-brick OFFSET (key & (brick-1)); the packed 60-bit code orders
# fields as (bx, by, bz, offset), so
#
#   * lexicographic (hi, lo) order groups all voxels of a brick contiguously
#     (bricks appear in brick-key order, voxels in offset order within), and
#   * the BRICK identity is the code with the offset bits masked out —
#     window applies find unique bricks by neighbor compare on the masked
#     code, for free, after the sort they already do.
#
# The voxel range is the same ±2^19 cells as pack_keys (brick axes get
# 20 - brick_bits bits), except the last BRICK of the +x axis is excluded
# (vs pack_keys' last VOXEL) to keep hi == EMPTY_HI unreachable.  Total
# payload is always 3*20 = 60 bits, left-aligned: lo's LOW 4 bits are ZERO —
# window engines fold the frame index into them, getting exact
# (voxel, frame-ascending) ordering from the same two sort keys with no
# extra array (frame is the least-significant field, so it never perturbs
# voxel/brick grouping).
# ---------------------------------------------------------------------------


def brick_layout(brick_bits: int):
    """(axis_bits, off_bits, lo_by_bits) field layout for a brick packing."""
    assert 1 <= brick_bits <= 3
    a = AXIS_BITS - brick_bits        # bits per brick axis
    o = 3 * brick_bits                # offset bits
    lo_by = 28 - (o + a)              # low bits of by that land in lo
    assert 0 <= lo_by < a
    return a, o, lo_by


def pack_brick_keys(
    keys: jnp.ndarray, brick_bits: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(N, 3) int32 voxel keys -> (hi, lo, in_range) with brick-major order.

    lo bits: [31 .. o+a+4] = by low bits, [o+a+3 .. o+4] = bz,
    [o+3 .. 4] = offset (x_off << 2b | y_off << b | z_off), [3 .. 0] = ZERO
    (frame space); hi carries bx and by's high bits.  Brick identity =
    (hi, lo & ~((1 << (o + 4)) - 1)); offset = (lo >> 4) & ((1 << o) - 1).
    """
    a, o, lo_by = brick_layout(brick_bits)
    brick = 1 << brick_bits
    bias = 1 << (a - 1)
    bk = (keys >> brick_bits) + jnp.int32(bias)
    off = keys & jnp.int32(brick - 1)
    amax = (1 << a) - 1
    in_range = jnp.all((bk >= 0) & (bk <= amax), axis=-1)
    # exclude the single all-ones-bx plane so hi == EMPTY_HI is unreachable
    in_range = in_range & (bk[..., 0] < amax)
    bx = bk[..., 0].astype(jnp.uint32)
    by = bk[..., 1].astype(jnp.uint32)
    bz = bk[..., 2].astype(jnp.uint32)
    offc = (
        (off[..., 0].astype(jnp.uint32) << (2 * brick_bits))
        | (off[..., 1].astype(jnp.uint32) << brick_bits)
        | off[..., 2].astype(jnp.uint32)
    )
    hi = (bx << (o + 2 * a - 28)) | (by >> lo_by)
    lo = (
        ((by & jnp.uint32((1 << lo_by) - 1)) << (o + a + 4))
        | (bz << (o + 4))
        | (offc << 4)
    )
    return hi, lo, in_range


def unpack_brick_keys(
    hi: jnp.ndarray, lo: jnp.ndarray, brick_bits: int
) -> jnp.ndarray:
    """Inverse of pack_brick_keys -> (N, 3) int32 voxel keys (ignores the
    low 4 frame bits of lo)."""
    a, o, lo_by = brick_layout(brick_bits)
    bias = 1 << (a - 1)
    bx = (hi >> (o + 2 * a - 28)).astype(jnp.int32)
    by = (
        ((hi & jnp.uint32((1 << (a - lo_by)) - 1)) << lo_by)
        | ((lo >> (o + a + 4)) & jnp.uint32((1 << lo_by) - 1))
    ).astype(jnp.int32)
    bz = ((lo >> (o + 4)) & jnp.uint32((1 << a) - 1)).astype(jnp.int32)
    off = (lo >> 4) & jnp.uint32((1 << o) - 1)
    ox = (off >> (2 * brick_bits)).astype(jnp.int32)
    oy = ((off >> brick_bits) & ((1 << brick_bits) - 1)).astype(jnp.int32)
    oz = (off & ((1 << brick_bits) - 1)).astype(jnp.int32)
    bk = jnp.stack([bx, by, bz], axis=-1) - jnp.int32(bias)
    return (bk << brick_bits) + jnp.stack([ox, oy, oz], axis=-1)


# ---------------------------------------------------------------------------
# Box-relative compact keys (single u32).
#
# Sorts dominate the records + window-apply programs and their cost is
# ~linear in total key+payload BYTES, so when a window's voxel extent fits a u32 the engines switch to BOX-RELATIVE keys:
# the host subtracts a per-window brick-aligned box origin (positions are
# host inputs and every emitted point lies within max_range of the sonar
# origin — reference 3d_mapper.py:404/:458 range gates — so the box
# [min(pos)-max_range, max(pos)+max_range] provably covers all candidates)
# and the device packs the offset brick-major into ONE u32:
#
#   key = bx:ax | by:ay | bz:az | offc:o      (o = 3*brick_bits)
#
# V = ax+ay+az+o bits.  The per-frame dedup appends the occupied bit
# (key<<1|occ — ONE sort array instead of three), the window apply appends
# the frame index (key<<f|frame), and compaction sorts promote their
# selection bit to bit 31 — so the engines require V + max(1, f) <= 31.
# 0xFFFFFFFF (EMPTY32) is the invalid/empty sentinel, unreachable because
# valid keys are < 2^31.  Global brick codes are recovered by translating
# the (few-k) compacted brick list back through the box origin.
# ---------------------------------------------------------------------------

EMPTY32 = np.uint32(0xFFFFFFFF)  # np, not jnp — see EMPTY_HI note


def pack_box_keys(
    keys: jnp.ndarray,
    box_min: jnp.ndarray,
    box_bits: Tuple[int, int, int],
    brick_bits: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(N, 3) int32 voxel keys -> ((N,) u32 box key, (N,) in_box).

    ``box_min`` (3,) int32 is the box-origin voxel key, BRICK-ALIGNED
    (each component a multiple of 2**brick_bits — the caller guarantees it,
    compute_window_boxes does); ``box_bits`` = per-axis BRICK bits
    (ax, ay, az).  Out-of-box keys still produce a (meaningless) code;
    callers must mask with ``in_box``.
    """
    ax, ay, az = box_bits
    o = 3 * brick_bits
    rel = keys - box_min  # (N, 3) box-relative voxel coords
    bk = rel >> brick_bits
    off = rel & jnp.int32((1 << brick_bits) - 1)
    lim = jnp.array([1 << ax, 1 << ay, 1 << az], jnp.int32)
    in_box = jnp.all((bk >= 0) & (bk < lim), axis=-1)
    offc = (
        (off[..., 0].astype(jnp.uint32) << (2 * brick_bits))
        | (off[..., 1].astype(jnp.uint32) << brick_bits)
        | off[..., 2].astype(jnp.uint32)
    )
    key = (
        (bk[..., 0].astype(jnp.uint32) << (ay + az + o))
        | (bk[..., 1].astype(jnp.uint32) << (az + o))
        | (bk[..., 2].astype(jnp.uint32) << o)
        | offc
    )
    return key, in_box


def unpack_box_brick(
    brick_id: jnp.ndarray,
    box_min: jnp.ndarray,
    box_bits: Tuple[int, int, int],
    brick_bits: int,
) -> jnp.ndarray:
    """(N,) u32 box BRICK ids (box key >> 3*brick_bits) -> (N, 3) int32
    GLOBAL voxel keys of each brick's corner (brick-aligned)."""
    ax, ay, az = box_bits
    bx = (brick_id >> (ay + az)).astype(jnp.int32)
    by = ((brick_id >> az) & jnp.uint32((1 << ay) - 1)).astype(jnp.int32)
    bz = (brick_id & jnp.uint32((1 << az) - 1)).astype(jnp.int32)
    return box_min + (jnp.stack([bx, by, bz], axis=-1) << brick_bits)


def compute_window_boxes(
    positions,
    max_range: float,
    resolution: float,
    window: int,
    brick_bits: int,
    frame_bits: int,
    margin_voxels: int = 2,
    min_bits=None,
):
    """Host gate: per-window box origins + static per-axis brick bits.

    ``positions``: (P, 3) sonar/world positions (float64 host array — the
    sensor origin of each ping; every candidate lies within ``max_range``
    of it, see the section comment above).  Returns
    ``(box_mins (n_windows, 3) int32 brick-aligned voxel keys,
    (ax, ay, az))`` — or ``None`` when the required key width exceeds the
    u32 budget (V + max(1, frame_bits) > 31) or a box would leave the
    global packable range; callers then keep the wide two-word path.

    Only ``box_mins`` varies per window (a dynamic program argument); the
    BITS are static and maxed over all windows so every window shares one
    compiled program.  ``min_bits`` (optional per-axis floor) lets
    streaming callers keep STICKY bits across chunks — reusing a previous
    chunk's wider program instead of recompiling for every extent change.
    """
    positions = np.asarray(positions, np.float64).reshape(-1, 3)
    P = len(positions)
    if P == 0:
        return None
    brick = 1 << brick_bits
    reach = float(max_range) + margin_voxels * float(resolution)
    mins, extents = [], []
    for w in range(0, P, window):
        seg = positions[w : w + window]
        lo = np.floor((seg.min(axis=0) - reach) / resolution).astype(np.int64)
        hi = np.floor((seg.max(axis=0) + reach) / resolution).astype(np.int64)
        bm = (lo >> brick_bits) << brick_bits  # brick-align down (floors)
        mins.append(bm)
        extents.append(hi - bm + 1)
    mins = np.stack(mins)
    n_bricks = (np.stack(extents).max(axis=0) + brick - 1) // brick
    bits = tuple(int(max(1, np.ceil(np.log2(b)))) for b in n_bricks)
    if min_bits is not None:
        bits = tuple(max(a, b) for a, b in zip(bits, min_bits))
    V = sum(bits) + 3 * brick_bits
    if V + max(1, frame_bits) > 31:
        return None
    # every box must stay inside the GLOBAL packable range so the apply's
    # brick translation (unpack_box_brick -> pack_brick_keys) cannot fail
    a = AXIS_BITS - brick_bits
    gmax = ((1 << (a - 1)) - 1) << brick_bits  # biased range, see pack_brick_keys
    gmin = -(1 << (a - 1)) << brick_bits
    span = (np.array([1 << b for b in bits], np.int64) << brick_bits)
    if (mins < gmin).any() or (mins + span > gmax).any():
        return None
    return mins.astype(np.int32), bits


def mix2(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    """32-bit avalanche of the packed key (murmur3 finalizer over a simple
    combine) — uniform bucket index bits for spatially clustered keys."""
    h = hi * jnp.uint32(0x9E3779B1) ^ lo * jnp.uint32(0x85EBCA6B)
    h = (h ^ (h >> 16)) * jnp.uint32(0x85EBCA6B)
    h = (h ^ (h >> 13)) * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)
