"""The metric-space zoo for evaluation — 10 similarity spaces.

Counterpart of ``wembed_tpu/eval/spaces.py`` (numpy): a vectorized
re-design of the reference's Embedding hierarchy
(reference: src/embeddingLib/include/embeddingSpace/Embedding.hpp:7-19 and
src/embeddingLib/src/embeddingSpace/*.cpp).  Lower similarity = more
similar.  Each space computes whole similarity ROWS at once (``rows``) —
the shape evaluation kernels want — plus per-pair values (``pairs``).

Formulas (space -> similarity of a, b):
  WeightedGeometric     |pa-pb| / (wa*wb)^(1/d)        WeightedGeometric.cpp:17-21
  Euclidean             |pa-pb|                        Euclidean.cpp:17-22
  DotProduct            -<pa,pb>                       DotProduct.cpp:16-25
  Cosine                -cos(pa,pb)                    Cosine.cpp:14-25
  Mercator (S1/SD)      hyperbolic disc distance       MercatorEmbedding.cpp:37-82
  WeightedNoDim         |pa-pb| / (wa*wb)              WeightedNoDim.cpp:16-21
  WeightedGeometricInf  |pa-pb|_inf / (wa*wb)^(1/d)    WeightedGeometricInf.cpp:19-24
  Poincare              hyperbolic ball distance       Poincare.cpp:16-30
  InfNorm               |pa-pb|_inf                    InfNorm.cpp:17-22
  Additive              |pa-pb| / (wa^(1/d)+wb^(1/d))  Additive.cpp:17-21
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class EmbeddingType(enum.IntEnum):
    """Mirrors the reference's EmbeddingType enum values 0-9
    (reference src/embeddingLib/include/embeddingIO/EmbeddingIO.hpp:11-22)."""

    WEIGHTED = 0
    EUCLIDEAN = 1
    DOT_PRODUCT = 2
    COSINE = 3
    MERCATOR = 4
    WEIGHTED_NO_DIM = 5
    WEIGHTED_INF = 6
    POINCARE = 7
    INF_NORM = 8
    ADDITIVE = 9


class Space:
    """Base: batched similarity rows / pairs over vertex indices."""

    n: int
    dimension: int

    def rows(self, ids: np.ndarray) -> np.ndarray:
        """(B, n) similarities of each id in ``ids`` to every vertex."""
        raise NotImplementedError

    def pairs(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """(k,) similarities for index pairs (a[i], b[i])."""
        raise NotImplementedError

    def similarity(self, a: int, b: int) -> float:
        return float(self.pairs(np.asarray([a]), np.asarray([b]))[0])


@dataclass
class _PositionSpace(Space):
    positions: np.ndarray  # (n, d)

    def __post_init__(self):
        self.positions = np.asarray(self.positions, dtype=np.float64)
        self.n = self.positions.shape[0]
        self.dimension = self.positions.shape[1]

    def _dist_rows(self, ids, ord=2):
        diff = self.positions[ids][:, None, :] - self.positions[None, :, :]
        if ord == 2:
            return np.sqrt((diff * diff).sum(-1))
        return np.abs(diff).max(-1)

    def _dist_pairs(self, a, b, ord=2):
        diff = self.positions[a] - self.positions[b]
        if ord == 2:
            return np.sqrt((diff * diff).sum(-1))
        return np.abs(diff).max(-1)


class Euclidean(_PositionSpace):
    def rows(self, ids):
        return self._dist_rows(ids)

    def pairs(self, a, b):
        return self._dist_pairs(a, b)


class InfNorm(_PositionSpace):
    def rows(self, ids):
        return self._dist_rows(ids, ord=np.inf)

    def pairs(self, a, b):
        return self._dist_pairs(a, b, ord=np.inf)


class DotProduct(_PositionSpace):
    def rows(self, ids):
        return -(self.positions[ids] @ self.positions.T)

    def pairs(self, a, b):
        return -(self.positions[a] * self.positions[b]).sum(-1)


class Cosine(_PositionSpace):
    def __post_init__(self):
        super().__post_init__()
        norms = np.linalg.norm(self.positions, axis=1, keepdims=True)
        self._unit = self.positions / np.where(norms > 0, norms, 1.0)

    def rows(self, ids):
        return -(self._unit[ids] @ self._unit.T)

    def pairs(self, a, b):
        return -(self._unit[a] * self._unit[b]).sum(-1)


@dataclass
class _WeightedSpace(_PositionSpace):
    weights: np.ndarray = None  # type: ignore[assignment]

    def __post_init__(self):
        super().__post_init__()
        self.weights = np.asarray(self.weights, dtype=np.float64)

    def _scale(self):
        raise NotImplementedError


class WeightedGeometric(_WeightedSpace):
    """The embedder's native model space."""

    def _denom(self):
        w = self.weights ** (1.0 / self.dimension)
        return w

    def rows(self, ids):
        w = self._denom()
        return self._dist_rows(ids) / (w[ids][:, None] * w[None, :])

    def pairs(self, a, b):
        w = self._denom()
        return self._dist_pairs(a, b) / (w[a] * w[b])


class WeightedGeometricInf(_WeightedSpace):
    def rows(self, ids):
        w = self.weights ** (1.0 / self.dimension)
        return self._dist_rows(ids, ord=np.inf) / (w[ids][:, None] * w[None, :])

    def pairs(self, a, b):
        w = self.weights ** (1.0 / self.dimension)
        return self._dist_pairs(a, b, ord=np.inf) / (w[a] * w[b])


class WeightedNoDim(_WeightedSpace):
    def rows(self, ids):
        return self._dist_rows(ids) / (self.weights[ids][:, None] * self.weights[None, :])

    def pairs(self, a, b):
        return self._dist_pairs(a, b) / (self.weights[a] * self.weights[b])


class Additive(_WeightedSpace):
    def rows(self, ids):
        w = self.weights ** (1.0 / self.dimension)
        return self._dist_rows(ids) / (w[ids][:, None] + w[None, :])

    def pairs(self, a, b):
        w = self.weights ** (1.0 / self.dimension)
        return self._dist_pairs(a, b) / (w[a] + w[b])


class Poincare(_PositionSpace):
    """Hyperbolic ball distance with clamped norms (Poincare.cpp:16-30)."""

    _EPS = 1e-5

    def __post_init__(self):
        super().__post_init__()
        self._sqnorm = np.clip((self.positions**2).sum(-1), 0.0, 1.0 - self._EPS)

    def _from_sqdist(self, sqdist, sa, sb):
        x = sqdist / ((1.0 - sa) * (1.0 - sb)) * 2.0 + 1.0
        z = np.sqrt(np.maximum(x * x - 1.0, 0.0))
        return np.log(x + z)

    def rows(self, ids):
        diff = self.positions[ids][:, None, :] - self.positions[None, :, :]
        sqdist = (diff * diff).sum(-1)
        return self._from_sqdist(sqdist, self._sqnorm[ids][:, None], self._sqnorm[None, :])

    def pairs(self, a, b):
        diff = self.positions[a] - self.positions[b]
        sqdist = (diff * diff).sum(-1)
        return self._from_sqdist(sqdist, self._sqnorm[a], self._sqnorm[b])


@dataclass
class Mercator(Space):
    """Hyperbolic S1/SD space from d-mercator coordinates
    (MercatorEmbedding.cpp:26-82).  For dimension 1: (radius, theta) pairs;
    for >= 2: radius + unit-sphere positions."""

    radii: np.ndarray
    angular: np.ndarray  # (n,) thetas for S1, (n, k) positions for SD

    def __post_init__(self):
        self.radii = np.asarray(self.radii, dtype=np.float64)
        self.angular = np.asarray(self.angular, dtype=np.float64)
        self.n = self.radii.shape[0]
        self.dimension = 1 if self.angular.ndim == 1 else self.angular.shape[1] - 1

    def _delta_theta_pairs(self, a, b):
        if self.angular.ndim == 1:
            return np.pi - np.abs(np.pi - np.abs(self.angular[a] - self.angular[b]))
        va, vb = self.angular[a], self.angular[b]
        cosang = (va * vb).sum(-1) / (
            np.linalg.norm(va, axis=-1) * np.linalg.norm(vb, axis=-1)
        )
        out = np.arccos(np.clip(cosang, -1.0, 1.0))
        out[np.abs(cosang - 1.0) < 1e-15] = 0.0
        return out

    def _distance(self, r1, r2, dtheta):
        same = (r1 == r2) & (dtheta == 0)
        radial = np.abs(r1 - r2)
        with np.errstate(over="ignore"):
            x = 0.5 * (
                (1 - np.cos(dtheta)) * np.cosh(r1 + r2)
                + (1 + np.cos(dtheta)) * np.cosh(r1 - r2)
            )
        hyper = np.arccosh(np.maximum(x, 1.0))
        out = np.where(dtheta == 0, radial, hyper)
        return np.where(same, 0.0, out)

    def pairs(self, a, b):
        return self._distance(self.radii[a], self.radii[b], self._delta_theta_pairs(a, b))

    def rows(self, ids):
        """Vectorized (len(ids), n) distance block — one broadcast matrix
        instead of an O(n) python pass per sampled node."""
        ids = np.asarray(ids)
        if self.angular.ndim == 1:
            diff = np.abs(self.angular[ids][:, None] - self.angular[None, :])
            dtheta = np.pi - np.abs(np.pi - diff)
        else:
            va = self.angular[ids]  # (k, dim+1)
            norms = np.linalg.norm(self.angular, axis=-1)
            cosang = (va @ self.angular.T) / (
                norms[ids][:, None] * norms[None, :]
            )
            dtheta = np.arccos(np.clip(cosang, -1.0, 1.0))
            dtheta[np.abs(cosang - 1.0) < 1e-15] = 0.0
        return self._distance(
            self.radii[ids][:, None], self.radii[None, :], dtheta
        )


def parse_embedding(
    emb_type: EmbeddingType | int, coordinates: np.ndarray, lp_norm: int = 2
) -> Space:
    """Factory matching EmbeddingIO::parseEmbedding column conventions
    (EmbeddingIO.cpp:19-108): weighted formats carry the weight in the LAST
    column; mercator carries kappa first, then radius (+ positions)."""
    del lp_norm  # only 2 supported, as in the reference
    emb_type = EmbeddingType(emb_type)
    coords = np.asarray(coordinates, dtype=np.float64)
    if emb_type == EmbeddingType.WEIGHTED:
        return WeightedGeometric(coords[:, :-1], weights=coords[:, -1])
    if emb_type == EmbeddingType.EUCLIDEAN:
        return Euclidean(coords)
    if emb_type == EmbeddingType.DOT_PRODUCT:
        return DotProduct(coords)
    if emb_type == EmbeddingType.COSINE:
        return Cosine(coords)
    if emb_type == EmbeddingType.MERCATOR:
        rest = coords[:, 1:]  # drop kappa
        if rest.shape[1] <= 2:
            return Mercator(radii=rest[:, 1], angular=rest[:, 0])  # theta, radius
        return Mercator(radii=rest[:, 0], angular=rest[:, 1:])
    if emb_type == EmbeddingType.WEIGHTED_NO_DIM:
        return WeightedNoDim(coords[:, :-1], weights=coords[:, -1])
    if emb_type == EmbeddingType.WEIGHTED_INF:
        return WeightedGeometricInf(coords[:, :-1], weights=coords[:, -1])
    if emb_type == EmbeddingType.POINCARE:
        return Poincare(coords)
    if emb_type == EmbeddingType.INF_NORM:
        return InfNorm(coords)
    if emb_type == EmbeddingType.ADDITIVE:
        return Additive(coords[:, :-1], weights=coords[:, -1])
    raise ValueError(f"unknown embedding type {emb_type}")
