"""Pure-NumPy golden oracle reproducing the reference numerics exactly.

This is a clean-room reimplementation of the semantics of the reference
``scripts/3d_mapper.py`` (SimpleOctree + SonarTo3DMapper), used ONLY as the
test oracle the device programs are validated against (1e-5 occupancy-probability
parity bar).  It is deliberately simple and slow; every behavioral subtlety is
cited to the reference file:line it reproduces.

Key semantics reproduced (see SURVEY.md section 2.1-2.2):
  * floor voxel keying, voxel-center reconstruction (3d_mapper.py:53-81)
  * adaptive free-space protection: occupied updates into voxels with
    p <= adaptive_threshold are scaled by (p/threshold)*max_ratio, including
    the fresh-voxel p=0.5 case (3d_mapper.py:95-102)
  * log-odds clamping, strict > extraction threshold with >=1.0 / <=0.0 edge
    cases (3d_mapper.py:107-110, 140-148)
  * first-hit scan, 50-bin occupied window, 10-bin free sampling,
    range-dependent vertical fan counts with int() truncation
    (3d_mapper.py:404-481)
  * negated-y sonar-frame geometry (3d_mapper.py:434-436)
  * per-frame per-voxel sum/count averaging with occupied-priority typing
    (3d_mapper.py:523-567)
  * bearing subsampling max(1, bearings // 256) (3d_mapper.py:528)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sonar_3d_reconstruction_tpu.config import MapperConfig
from sonar_3d_reconstruction_tpu.geometry import (
    pose_matrix_from_quaternion,
    pose_matrix_from_rpy,
)

Key = Tuple[int, int, int]


def sigmoid(x: float) -> float:
    return 1.0 / (1.0 + np.exp(-x))


class GoldenMap:
    """Sparse log-odds voxel map (reference SimpleOctree, 3d_mapper.py:19-194)."""

    def __init__(self, cfg: MapperConfig):
        self.cfg = cfg
        self.log_odds: Dict[Key, float] = {}
        self.min_bounds = np.full(3, np.inf)
        self.max_bounds = np.full(3, -np.inf)

    def key_of(self, p: np.ndarray) -> Key:
        # floor keying (3d_mapper.py:63-66)
        r = self.cfg.voxel_resolution
        return (
            int(np.floor(p[0] / r)),
            int(np.floor(p[1] / r)),
            int(np.floor(p[2] / r)),
        )

    def center_of(self, key: Key) -> np.ndarray:
        # voxel center (3d_mapper.py:78-81)
        r = self.cfg.voxel_resolution
        return (np.asarray(key, dtype=np.float64) + 0.5) * r

    def apply_update(self, point: np.ndarray, update: float, adaptive: bool) -> None:
        """One voxel update (reference update_voxel, 3d_mapper.py:83-115)."""
        cfg = self.cfg
        key = self.key_of(point)
        if adaptive and cfg.adaptive_update and update > 0:
            cur = self.log_odds.get(key, 0.0)
            p = sigmoid(cur)
            if p <= cfg.adaptive_threshold:
                update = update * (p / cfg.adaptive_threshold) * cfg.adaptive_max_ratio
        new = self.log_odds.get(key, 0.0) + update
        self.log_odds[key] = float(np.clip(new, cfg.log_odds_min, cfg.log_odds_max))
        if cfg.dynamic_expansion:
            self.min_bounds = np.minimum(self.min_bounds, point)
            self.max_bounds = np.maximum(self.max_bounds, point)

    def occupied(self, min_probability: float) -> List[Tuple[np.ndarray, float]]:
        """Occupied voxels above probability threshold (3d_mapper.py:127-153)."""
        cfg = self.cfg
        if min_probability >= 1.0:
            thr = cfg.log_odds_max - 0.01
        elif min_probability <= 0.0:
            thr = cfg.log_odds_min
        else:
            thr = np.log(min_probability / (1.0 - min_probability))
        out = []
        for key, lo in self.log_odds.items():
            if lo > thr:  # strict comparison (3d_mapper.py:148)
                out.append((self.center_of(key), sigmoid(lo)))
        return out

    def classified(self, min_probability: float) -> Dict[str, List[Tuple[np.ndarray, float]]]:
        """Three-way classification (3d_mapper.py:155-188)."""
        free_thr = np.log(0.3 / 0.7)  # hard-coded in reference (3d_mapper.py:170)
        occ_thr = np.log(min_probability / (1.0 - min_probability))
        buckets: Dict[str, List[Tuple[np.ndarray, float]]] = {
            "free": [], "unknown": [], "occupied": []
        }
        for key, lo in self.log_odds.items():
            entry = (self.center_of(key), sigmoid(lo))
            if lo < free_thr:
                buckets["free"].append(entry)
            elif lo > occ_thr:
                buckets["occupied"].append(entry)
            else:
                buckets["unknown"].append(entry)
        return buckets


class GoldenMapper:
    """Reference-parity ping processor (reference SonarTo3DMapper,
    3d_mapper.py:197-650), organized as: emit candidate points per ray ->
    per-frame voxel accumulation -> averaged adaptive map update."""

    def __init__(self, cfg: MapperConfig):
        self.cfg = cfg
        self.map = GoldenMap(cfg)
        self.T_sonar_to_base = pose_matrix_from_rpy(
            np.asarray(cfg.sonar_position, dtype=np.float64),
            np.asarray(cfg.sonar_orientation, dtype=np.float64),
        )
        self.frame_count = 0
        # per-frame emission counts (reference frame_update_counts :308, :525)
        self.last_frame_counts: Dict[Key, int] = {}
        # bearing table (3d_mapper.py:295-299); rebuilt on width change (511-517)
        self._bearing_width = cfg.image_width
        self._bearings = self._bearing_table(cfg.image_width)

    def _bearing_table(self, width: int) -> np.ndarray:
        h = self.cfg.horizontal_fov_rad / 2.0
        return np.linspace(-h, h, width)

    # ------------------------------------------------------------------
    def _emit_ray(
        self,
        bearing: float,
        profile: np.ndarray,
        T_sonar_to_world: np.ndarray,
    ) -> List[Tuple[np.ndarray, float, bool]]:
        """Candidate emissions for one ray: (world_point, log_odds, is_occupied).

        Reproduces reference process_sonar_ray (3d_mapper.py:387-483).
        """
        cfg = self.cfg
        n_bins = len(profile)
        rres = cfg.max_range / n_bins  # 3d_mapper.py:404
        half_ap = cfg.half_aperture_rad

        hits = np.nonzero(profile > cfg.intensity_threshold)[0]
        first_hit = int(hits[0]) if hits.size else n_bins  # 3d_mapper.py:406-413

        out: List[Tuple[np.ndarray, float, bool]] = []

        def fan_points(range_m: float, num_vertical: float) -> np.ndarray:
            nv = int(num_vertical)
            steps = np.arange(-nv, nv + 1, dtype=np.float64)
            vang = (steps / max(1, nv)) * half_ap  # 3d_mapper.py:430, 466
            # sonar frame: +X fwd, +Y right (negated), +Z down (3d_mapper.py:432-436)
            local = np.stack(
                [
                    range_m * np.cos(vang) * np.cos(bearing),
                    -range_m * np.cos(vang) * np.sin(bearing),
                    range_m * np.sin(vang),
                    np.ones_like(vang),
                ],
                axis=-1,
            )
            return local @ T_sonar_to_world.T

        # free space before first hit, sparse sampling (3d_mapper.py:419-446)
        for idx in range(0, first_hit, cfg.free_sampling_step):
            range_m = idx * rres
            if range_m < cfg.min_range:
                continue
            spread = range_m * np.tan(half_ap)
            nv = max(1, int(spread / (cfg.voxel_resolution * 4)))  # 3d_mapper.py:427
            for pt in fan_points(range_m, nv):
                if cfg.z_filter_enabled and pt[2] < cfg.z_filter_min:
                    continue
                out.append((pt[:3], cfg.log_odds_free, False))

        # occupied window after first hit (3d_mapper.py:449-481)
        if first_hit < n_bins:
            for idx in range(first_hit, min(first_hit + cfg.occupied_window, n_bins)):
                if profile[idx] <= cfg.intensity_threshold:
                    continue
                range_m = idx * rres
                if range_m < cfg.min_range:
                    continue
                if range_m > cfg.max_range:
                    break
                spread = range_m * np.tan(half_ap)
                nv = max(2, int(spread / (cfg.voxel_resolution * 1.5)))  # :463
                for pt in fan_points(range_m, nv):
                    if cfg.z_filter_enabled and pt[2] < cfg.z_filter_min:
                        continue
                    out.append((pt[:3], cfg.log_odds_occupied, True))
        return out

    # ------------------------------------------------------------------
    def process_ping(
        self,
        polar_image: np.ndarray,
        position,
        quaternion,
    ) -> Dict[str, float]:
        """One ping -> map update (reference process_sonar_image,
        3d_mapper.py:485-595).  Image layout: rows=range bins, cols=bearings."""
        cfg = self.cfg
        self.frame_count += 1
        polar_image = np.asarray(polar_image)
        range_bins, bearing_bins = polar_image.shape
        if bearing_bins != self._bearing_width:  # 3d_mapper.py:511-517
            self._bearings = self._bearing_table(bearing_bins)
            self._bearing_width = bearing_bins

        T_base_to_world = pose_matrix_from_quaternion(
            np.asarray(position, dtype=np.float64),
            np.asarray(quaternion, dtype=np.float64),
        )
        T_sonar_to_world = T_base_to_world @ self.T_sonar_to_base  # :519-521

        # per-frame accumulation: sum / count / occupied-priority (:523-551)
        acc: Dict[Key, List] = {}
        step = max(1, bearing_bins // cfg.max_rays)  # :528
        half_fov = cfg.horizontal_fov_rad / 2.0
        for b_idx in range(0, bearing_bins, step):
            bearing = self._bearings[b_idx]
            if abs(bearing) > half_fov:  # :533-535 (FOV gate)
                continue
            for pt, lo, is_occ in self._emit_ray(
                bearing, polar_image[:, b_idx], T_sonar_to_world
            ):
                key = self.map.key_of(pt)
                slot = acc.setdefault(key, [0.0, 0, False])
                slot[0] += lo
                slot[1] += 1
                slot[2] = slot[2] or is_occ  # occupied priority (:544-545)

        # the reference's per-frame emission-count debug dict
        # (frame_update_counts, 3d_mapper.py:525, 550): parity oracle for
        # SonarMapper.frame_update_counts
        self.last_frame_counts = {k: c for k, (_, c, _) in acc.items()}

        num_occ = num_free = 0
        for key, (s, c, is_occ) in acc.items():  # averaged apply (:553-567)
            center = self.map.center_of(key)
            self.map.apply_update(center, s / c, adaptive=is_occ)
            if is_occ:
                num_occ += 1
            else:
                num_free += 1

        return {
            "frame_count": self.frame_count,
            "num_occupied": num_occ,
            "num_free": num_free,
            "num_voxels": len(self.map.log_odds),
        }

    # ------------------------------------------------------------------
    def point_cloud(self, include_free: bool = False) -> Dict:
        """Map extraction (reference get_point_cloud, 3d_mapper.py:597-642)."""
        cfg = self.cfg
        if include_free:
            cls = self.map.classified(cfg.min_probability)
            return {
                "occupied": cls["occupied"],
                "free": cls["free"],
                "unknown": cls["unknown"],
                "num_voxels": len(self.map.log_odds),
                "bounds": (self.map.min_bounds.copy(), self.map.max_bounds.copy()),
            }
        occ = self.map.occupied(cfg.min_probability)
        points = np.array([p for p, _ in occ]) if occ else np.empty((0, 3))
        probs = np.array([q for _, q in occ]) if occ else np.empty(0)
        return {
            "points": points,
            "probabilities": probs,
            "num_voxels": len(self.map.log_odds),
            "num_occupied": len(occ),
        }
