"""Genz-Malik embedded cubature rule (CUHRE "rule 9" family).

A copy of ``gpuintegration_tpu/ops/genz_malik.py`` (NumPy only): importing
that module would run the JAX package's ``__init__``, so the port keeps
its own.  The arithmetic is unchanged, and the tables are bitwise equal
(tests/test_torch_rule_tables.py).

Constructs, in pure NumPy on the host, the degree-9 fully-symmetric
cubature rule with four embedded null rules (NRULES=5) over the unit cube
[0,1]^ndim used by CUHRE and by the reference's PAGANI integrator
(reference: cuda/pagani/quad/GPUquad/Rule.cuh:25-270 builds the same rule
as device constant tables; Phases.cuh:157-217 expands the permutation
tables into a dense generator array on the GPU).

Everything is precomputed on the host once per ndim:

* ``points``      -- (feval, ndim) signed generator abscissae, one row per
                     cubature point, in the canonical ordering required by
                     the fourth-difference bisection-dimension logic
                     (center first, then the _A1- and _A2-generator orbits
                     in (dim ascending, +/-) pair order -- the two orbits
                     entering the fourth difference, whose ratio is
                     (_A2/_A1)^2; see Sample.cuh:194-218).
* ``weights``     -- (feval, 5) per-point weights for the 5 embedded rules,
                     (the rule evaluation reduces per orbit instead, with
                     ``orbit_weights``).
* ``scale,norm``  -- (9, 5) null-rule scale/normalisation tables for the
                     CUHRE error model (Rule.cuh:256-269).
* ``ratio``       -- (a2/a1)^2 constant of the fourth-difference formula
                     (Sample.cuh:195-196).

The magic constants below are the published coefficients of the
Genz-Malik degree-9 rule (A. Genz, A. Malik, "An imbedded family of fully
symmetric numerical integration rules", SIAM J. Numer. Anal. 20 (1983));
the same values appear in CUBA's CUHRE and in the reference's Rule.cuh.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np

NRULES = 5
NSETS = 9

# Generator abscissae (Rule.cuh:201-205): lambda values of the rule.
_A1 = 0.4779536579022695061928604197171830064732
_A2 = 0.2030285873691198677998034402373279133258
_A3 = 0.4476273546261781288207704806530998539285
_A4 = 0.125
_AL = 0.3430378987808781457001426145164678603407  # "l" corner generator
# Every non-zero |abscissa| of the rule, in the order of the orbits that
# introduce them: a point's coordinate is 0 or +-one of these five.
GENERATORS = (_A1, _A2, _A3, _A4, _AL)


def feval_per_region(ndim: int) -> int:
    """Number of cubature points per region.

    1 + 8n + 2n(n-1) + 4n(n-1) + 4n(n-1)(n-2)/3 + 2^n
    (reference: cuda/pagani/quad/quad.h:68-75, CuhreFuncEvalsPerRegion).
    """
    n = ndim
    return (1 + 2 * n + 2 * n + 2 * n + 2 * n + 2 * n * (n - 1)
            + 4 * n * (n - 1) + 4 * n * (n - 1) * (n - 2) // 3 + (1 << n))


def _set_counts(ndim: int) -> np.ndarray:
    """Number of points in each of the 9 fully-symmetric orbits
    (reference: Rule.cuh:155-172)."""
    n = ndim
    return np.array([
        1,
        2 * n, 2 * n, 2 * n, 2 * n,
        2 * n * (n - 1),
        4 * n * (n - 1),
        4 * n * (n - 1) * (n - 2) // 3,
        1 << n,
    ], dtype=np.int64)


def _rule_weights(ndim: int) -> np.ndarray:
    """(9, 5) weight table of the embedded rule family.

    Row s, column r: weight applied to every point of orbit s in embedded
    rule r (r=0 the degree-9 rule, r=1..4 null rules of decreasing degree).
    Same polynomial-in-ndim coefficients as reference Rule.cuh:36-147.
    """
    n = float(ndim)
    two_pow_n = float(1 << ndim)

    # Recurring sub-expressions of the published coefficient polynomials.
    p0 = n * (n * (n * (-.002361170967785511788400941242259231309691)
                   + .1141539002385732526821323741697655347686)
              + (-.6383392007670238909386026193674701393074)) \
        + .7484998850468520800423030047583803945205
    p1 = n * (n * (n * (-.001432401703339912514196154599769007103671)
                   + .05747150786448972594860897296200006759892)
              + (-.1422510457143424323449521620935950679394)) \
        - (-.06287502873828697998942424881040490136987)
    q0 = n * (n * .003541756451678267682601411863388846964536
              + (-.07260936739589367960492815865074633743652)) \
        + .1055749162521899101218622863269817454540
    q1 = n * (n * .002148602555009868771294231899653510655506
              + (-.03226856389295394999786630399875134318006)) \
        + .01063678399023121748083624225818915724455
    r0 = n * (-.04508628929435784075980562738240804429658) \
        + .2141588352435279340097929526588394300172
    r1 = n * (-.02735154652654564472203690086290223507436) \
        + .05494106704871123410060080562462135546101
    s0 = .01553241727660705326386197156586357005224 \
        - n * .003541756451678267682601411863388846964536
    s1 = .003532809960709087023561817517751309380604 \
        - n * .002148602555009868771294231899653510655506

    w = np.zeros((NSETS, NRULES), dtype=np.float64)
    # Orbit 0: the center point.
    w[0] = [
        p0,
        p1,
        n * .2545911332489590890011611142429070613156 - p1,
        n * (n * (-1.207328566678236261002219995185143356737)
             + .8956736576416067650809467826488567200939) - 1 + p0,
        n * (-.3647935698604914666100134551377381205297) + 1 - p0,
    ]
    # Orbit 1: +/- a1 e_i.
    w[1] = [
        q0,
        q1,
        .01468910249614349017540783437728097691502 - q1,
        n * .5113470834646759143109387357149329909126
        + .4597644812080634464633352781605214342691 + q0,
        .1823967849302457333050067275688690602649 - q0,
    ]
    # Orbit 2: +/- a2 e_i.
    w[2] = [
        r0,
        r1,
        .1193759620257077529708962121565290178730 - r1,
        n * .6508951939192025059314756320878023215278
        + .1474493982943446016775696826942585013243,
        -r0,
    ]
    # Orbit 3: +/- a3 e_i.
    w[3] = [
        .05769338449097348357291272840392627722165,
        .03499962660214358382244159694487155861542,
        -.05769338449097348357291272840392627722165,
        -1.386862771927828143599782668709014266770,
        -.05769338449097348357291272840392627722165,
    ]
    # Orbit 4: +/- a4 e_i (only contributes to the degree-5 null rule).
    w[4] = [0., 0., -.2386668732575008878964134721962088068396, 0., 0.]
    # Orbit 5: (+/-a1, +/-a1) pairs.
    w[5] = [
        s0,
        s1,
        -s1,
        .09231719987444221619017126187763868745587 + s0,
        -s0,
    ]
    # Orbit 6: (+/-a1, +/-a2) ordered pairs.
    w[6] = [
        .02254314464717892037990281369120402214829,
        .01367577326327282236101845043145111753718,
        -.01367577326327282236101845043145111753718,
        -.3254475969596012529657378160439011607639,
        -.02254314464717892037990281369120402214829,
    ]
    # Orbit 7: (+/-a1, +/-a1, +/-a1) triples.
    w[7] = [
        .001770878225839133841300705931694423482268,
        .001074301277504934385647115949826755327753,
        -.001074301277504934385647115949826755327753,
        .001770878225839133841300705931694423482268,
        -.001770878225839133841300705931694423482268,
    ]
    # Orbit 8: the 2^n corners (+/-l, ..., +/-l).
    w[8] = np.array([
        .2515001149531479199576969952416196054795,
        -.06287502873828697998942424881040490136987,
        .06287502873828697998942424881040490136987,
        .2515001149531479199576969952416196054795,
        -.2515001149531479199576969952416196054795,
    ]) / two_pow_n
    return w


def _scale_norm(weights: np.ndarray, counts: np.ndarray):
    """Null-rule scale/norm tables for the CUHRE error model.

    For each orbit s and null rule r in {1,2,3}:
      scale[s,r] = 100 if w[s,r]==0 else -w[s,r+1]/w[s,r]
      norm[s,r]  = 1 / sum_x counts[x]*|w[x,r+1] + scale[s,r]*w[x,r]|
    (reference: Rule.cuh:256-269).
    """
    scale = np.zeros((NSETS, NRULES), dtype=np.float64)
    norm = np.zeros((NSETS, NRULES), dtype=np.float64)
    for s in range(NSETS):
        for r in range(1, NRULES - 1):
            sc = 100.0 if weights[s, r] == 0 else -weights[s, r + 1] / weights[s, r]
            total = np.sum(counts * np.abs(weights[:, r + 1] + sc * weights[:, r]))
            scale[s, r] = sc
            norm[s, r] = 1.0 / total
    return scale, norm


def _orbit_points(ndim: int):
    """Expand the 9 orbits into an explicit, deterministically-ordered
    point list. Returns (points (feval, ndim) float64, set_id (feval,) int).

    Ordering contract (required by the fourth-difference logic,
    Sample.cuh:194-218): index 0 is the center; indices 1..2n are the _A1
    orbit in (dim 0 +, dim 0 -, dim 1 +, ...) order; indices 2n+1..4n the
    _A2 orbit in the same order (ratio = (_A2/_A1)^2 in rule_eval).
    Orbits 3+ may be in any fixed order.
    """
    n = ndim
    head, head_sid = orbit_head(n)
    # Orbit 8: all 2^n sign corners of (l, ..., l), in the order of
    # itertools.product((+1, -1), repeat=n): axis d of corner k is -l where
    # bit n-1-d of k is set.  Built as one array (2^n points: 16.8M at 24D)
    # with the bits of _AL * (+-1.0).
    k = np.arange(1 << n, dtype=np.int64)
    corners = np.empty((1 << n, n))
    for d in range(n):
        corners[:, d] = np.where((k >> (n - 1 - d)) & 1, -_AL, _AL)

    points = np.concatenate([head, corners])
    set_id = np.concatenate([head_sid, np.full(1 << n, 8, dtype=np.int64)])
    assert points.shape[0] == feval_per_region(n), (
        points.shape, feval_per_region(n))
    return points, set_id


def orbit_head(ndim: int):
    """Orbits 0-7 of ``_orbit_points``' list, every point but the 2^n
    corners, in its order: (points (k8, ndim) float64, set_id (k8,)), at
    any ndim without the corners' memory (3.2 GB at 24D)."""
    n = ndim
    pts: list[np.ndarray] = []
    sid: list[int] = []

    def add(vec, s):
        pts.append(np.asarray(vec, dtype=np.float64))
        sid.append(s)

    # Orbit 0: center.
    add(np.zeros(n), 0)
    # Orbits 1-4: single-axis generators, (dim asc, + then -) pairs.
    for s, a in enumerate((_A1, _A2, _A3, _A4), start=1):
        for d in range(n):
            for sign in (+1.0, -1.0):
                v = np.zeros(n)
                v[d] = sign * a
                add(v, s)
    # Orbit 5: (a1, a1) on unordered axis pairs, all 4 sign patterns.
    for i, j in itertools.combinations(range(n), 2):
        for si in (+1.0, -1.0):
            for sj in (+1.0, -1.0):
                v = np.zeros(n)
                v[i] = si * _A1
                v[j] = sj * _A1
                add(v, 5)
    # Orbit 6: (a1, a2) on ordered axis pairs (values differ), 4 signs.
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            for si in (+1.0, -1.0):
                for sj in (+1.0, -1.0):
                    v = np.zeros(n)
                    v[i] = si * _A1
                    v[j] = sj * _A2
                    add(v, 6)
    # Orbit 7: (a1, a1, a1) on unordered axis triples, 8 sign patterns.
    for i, j, k in itertools.combinations(range(n), 3):
        for si in (+1.0, -1.0):
            for sj in (+1.0, -1.0):
                for sk in (+1.0, -1.0):
                    v = np.zeros(n)
                    v[i] = si * _A1
                    v[j] = sj * _A1
                    v[k] = sk * _A1
                    add(v, 7)
    return np.stack(pts), np.asarray(sid, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class GenzMalikRule:
    """Host-side constant tables of the degree-9 embedded rule for one ndim."""

    ndim: int
    feval: int                 # true number of cubature points
    points: np.ndarray         # (feval, ndim) signed abscissae in [-.5, .5]
    point_weights: np.ndarray  # (feval, NRULES) per-point weights
    orbit_weights: np.ndarray  # (NSETS, NRULES)
    counts: np.ndarray         # (NSETS,) points per orbit
    scale: np.ndarray          # (NSETS, NRULES) null-rule scales
    norm: np.ndarray           # (NSETS, NRULES) null-rule norms
    ratio: float               # (a2/a1)^2 fourth-difference constant

    def padded(self, multiple: int = 128):
        """Return (points_padded, weights_padded) with the point axis padded
        to a multiple of `multiple` using zero-weight center points (the
        reference's padded table layout, kept so the tables compare
        bitwise)."""
        pad = (-self.feval) % multiple
        if pad == 0:
            return self.points, self.point_weights
        pts = np.concatenate(
            [self.points, np.zeros((pad, self.ndim))], axis=0)
        wts = np.concatenate(
            [self.point_weights, np.zeros((pad, NRULES))], axis=0)
        return pts, wts


@functools.lru_cache(maxsize=None)
def genz_malik_rule(ndim: int) -> GenzMalikRule:
    """Build (and cache) the rule tables for a given dimension (2 <= ndim)."""
    if ndim < 2:
        raise ValueError("Genz-Malik rule requires ndim >= 2 "
                         "(use mcubes/vegas1d for 1-D integrals)")
    weights = _rule_weights(ndim)
    counts = _set_counts(ndim)
    scale, norm = _scale_norm(weights, counts)
    points, set_id = _orbit_points(ndim)
    point_weights = weights[set_id]  # (feval, NRULES)
    return GenzMalikRule(
        ndim=ndim,
        feval=points.shape[0],
        points=points,
        point_weights=point_weights,
        orbit_weights=weights,
        counts=counts,
        scale=scale,
        norm=norm,
        ratio=(_A2 / _A1) ** 2,
    )
