"""A procedural humanoid in the official SMPL-X ``.npz`` layout, drawn with
numpy from a seed: SMPL-X's 55-joint tree (``kintree_table``, the root's
parent stored as 4294967295 as the official files store it), a T-pose rest
skeleton about 1.7 m tall, and a closed tube of vertices along each chain
of bones (:data:`TUBES`), whose ring and segment counts give SMPL-X's
10,475 vertices and 20,908 faces to within 1% and the hands the share of
the vertices that SMPL-X's MANO-derived hands hold (two of MANO's 778-vertex
hands, about 15%, assumed).  Nothing of the real SMPL-X files (licensed,
not in the repository) is read.

The file holds what the program's loader reads: ``v_template``,
``shapedirs`` [V, 3, 400] (300 shape and 100 expression directions),
``posedirs`` [V, 3, 486], ``J_regressor``, ``weights``, ``kintree_table``,
``f`` and the MANO hand means ``hands_meanl`` / ``hands_meanr`` (45 each);
no landmark tables, which the render path never reads.

- ``weights``: a vertex at fraction ``t`` along the bone from joint ``a`` to
  its child ``b`` weighs ``a`` by ``1 - t`` and ``b`` by ``t``, as
  ``make_test_body`` weights its chain; a tube's tip past its last joint,
  and each cap's centre, weigh that joint alone.
- ``J_regressor``: the mean of the ring centred at each joint.
- ``shapedirs``: each direction N(0, 0.01^2) per joint and axis (the scale
  of ``make_test_body``'s per-vertex draws), blended over the vertices by
  ``weights``, so a shape moves whole limbs; the 100 expression directions
  are drawn so for the head, jaw and eye joints alone and are zero on the
  rest of the body, as SMPL-X's are off the face.
- ``posedirs``: N(0, 1e-4^2) per vertex, as ``make_test_body``'s.
- the hand means: N(0, 0.2^2) per axis-angle component.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

# SMPL-X's kinematic tree: global, 21 body joints, jaw, two eyes, then the
# left and right hands' index, middle, pinky, ring and thumb (3 joints each).
PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
           15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
           21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53)
ROOT_PARENT = 4294967295
NUM_JOINTS = 55
NUM_SHAPE, NUM_EXPRESSION = 300, 100
SMPLX_VERTS, SMPLX_FACES = 10475, 20908
HANDS_SHARE = 2 * 778 / SMPLX_VERTS  # two MANO hands, assumed
FACE_JOINTS = (15, 22, 23, 24)  # head, jaw, eyes: the expression directions' support
SHAPE_STD, POSE_STD, HAND_MEAN_STD = 0.01, 1e-4, 0.2

# The rest skeleton (metres; y up, the body facing +z, its left at +x): the
# centre line, then the left side, mirrored in x for the right.
_CENTRE = {0: (0.0, 0.0, 0.0), 3: (0.0, 0.10, -0.01), 6: (0.0, 0.23, 0.0),
           9: (0.0, 0.29, 0.01), 12: (0.0, 0.50, -0.01), 15: (0.0, 0.58, 0.02),
           22: (0.0, 0.56, 0.04)}
_LEFT = {1: (0.085, -0.09, 0.0), 4: (0.10, -0.50, 0.01), 7: (0.10, -0.90, -0.02),
         10: (0.11, -0.96, 0.10), 13: (0.07, 0.40, -0.01), 16: (0.18, 0.42, -0.02),
         18: (0.44, 0.42, -0.03), 20: (0.69, 0.42, -0.02), 23: (0.032, 0.64, 0.085),
         # index, middle, pinky, ring, thumb: the hand flat, palm down
         25: (0.78, 0.42, 0.012), 26: (0.815, 0.42, 0.014), 27: (0.84, 0.42, 0.015),
         28: (0.785, 0.42, -0.008), 29: (0.825, 0.42, -0.008), 30: (0.853, 0.42, -0.008),
         31: (0.77, 0.42, -0.046), 32: (0.797, 0.42, -0.048), 33: (0.815, 0.42, -0.049),
         34: (0.78, 0.42, -0.028), 35: (0.815, 0.42, -0.029), 36: (0.84, 0.42, -0.030),
         37: (0.715, 0.41, 0.022), 38: (0.74, 0.405, 0.045), 39: (0.765, 0.40, 0.06)}
_MIRROR = {1: 2, 4: 5, 7: 8, 10: 11, 13: 14, 16: 17, 18: 19, 20: 21, 23: 24,
           **{j: j + 15 for j in range(25, 40)}}


def rest_joints() -> np.ndarray:
    """[55, 3] rest joint positions (float64)."""
    J = np.zeros((NUM_JOINTS, 3))
    for j, p in _CENTRE.items():
        J[j] = p
    for j, p in _LEFT.items():
        J[j] = p
        J[_MIRROR[j]] = (-p[0], p[1], p[2])
    return J


class Tube(NamedTuple):
    """A closed tube along a chain of joints, each joint a child of the
    one before: ``ring`` vertices a ring, ``segments[i]`` rows of rings
    along bone ``i`` (the chain's first ring at its first joint), then
    ``tip_segments`` rows along ``tip`` (an offset past the last joint,
    or None) and a fan cap at each end; ``radii`` the radius at each joint
    and at the tip's end."""

    chain: Tuple[int, ...]
    ring: int
    segments: Tuple[int, ...]
    radii: Tuple[float, ...]
    tip: Optional[Tuple[float, float, float]] = None
    tip_segments: int = 0


def _sides(left: Tube) -> Tuple[Tube, Tube]:
    """A left-side tube and its mirror image on the right."""
    def mirror(j):
        return _MIRROR.get(j, j)

    tip = None if left.tip is None else (-left.tip[0], left.tip[1], left.tip[2])
    return left, left._replace(chain=tuple(map(mirror, left.chain)), tip=tip)


_FINGER_RADII = (0.011, 0.009, 0.008, 0.007, 0.005)


def _finger(base: int, ring: int, segments, tip_len: float, tip_segments: int) -> Tube:
    J = rest_joints()
    d = J[base + 2] - J[base + 1]
    tip = tuple(float(x) for x in tip_len * d / np.linalg.norm(d))
    return Tube((20, base, base + 1, base + 2), ring, segments, _FINGER_RADII, tip,
                tip_segments)


def _layout(torso, head, leg, arm, finger, jaw, eye) -> Tuple[Tube, ...]:
    """The tubes, given each part's (ring, segments a bone, tip segments)."""
    tubes = [Tube((0, 3, 6, 9, 12), torso[0], torso[1], (0.12, 0.12, 0.13, 0.14, 0.055)),
             Tube((12, 15), head[0], head[1], (0.05, 0.09, 0.035), (0.0, 0.16, 0.0), head[2]),
             Tube((15, 22), jaw[0], jaw[1], (0.03, 0.035, 0.015), (0.0, -0.03, 0.05), jaw[2])]
    tubes += _sides(Tube((0, 1, 4, 7, 10), leg[0], leg[1], (0.07, 0.085, 0.055, 0.04, 0.035,
                                                          0.02), (0.0, -0.01, 0.07), leg[2]))
    tubes += _sides(Tube((9, 13, 16, 18, 20), arm[0], arm[1], (0.05, 0.05, 0.048, 0.038,
                                                               0.028)))
    tubes += _sides(Tube((15, 23), eye[0], eye[1], (0.012, 0.012, 0.008), (0.0, 0.0, 0.015),
                         eye[2]))
    for base in (25, 28, 31, 34, 37):  # index, middle, pinky, ring, thumb
        tubes += _sides(_finger(base, finger[0], finger[1], 0.02, finger[2]))
    return tuple(tubes)


# The published counts' layout: 10,474 vertices (-0.01%), 20,872 faces
# (-0.17%), the hands 1,540 vertices (14.7%).
TUBES = _layout(torso=(48, (11, 11, 11, 12)), head=(40, (12,), 19),
                leg=(32, (6, 16, 16, 8), 4), arm=(24, (4, 4, 14, 14)),
                finger=(8, (6, 5, 4), 3), jaw=(20, (4,), 6), eye=(12, (4,), 2))
# A small layout for tests on the CPU: the same joints, tree and tubes.
SMALL_TUBES = _layout(torso=(8, (2, 1, 1, 1)), head=(8, (1,), 1), leg=(6, (1, 2, 2, 1), 1),
                      arm=(6, (1, 1, 2, 2)), finger=(4, (1, 1, 1), 1), jaw=(4, (1,), 1),
                      eye=(4, (1,), 1))
LAYOUTS = {"published": TUBES, "small": SMALL_TUBES}


def _frame(d: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Two unit vectors (u, v) across direction ``d`` with v = u x d, so
    that the tube's faces wind outward."""
    d = d / np.linalg.norm(d)
    ref = np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(d, ref)
    u /= np.linalg.norm(u)
    return u, np.cross(u, d)


def _tube(t: Tube, J: np.ndarray, v0: int):
    """Vertices, faces (indices from ``v0``), per-vertex (joint a, joint b,
    t) weights and the row index of each chain joint's ring."""
    centres, radii, dirs, wts, joint_row = [], [], [], [], {}
    pts = [J[j] for j in t.chain]
    n_bones = len(t.chain) - 1
    for i in range(n_bones):
        a, b = t.chain[i], t.chain[i + 1]
        d = pts[i + 1] - pts[i]
        first = 0 if i == 0 else 1
        for s in range(first, t.segments[i] + 1):
            f = s / t.segments[i]
            if s == 0:
                joint_row[a] = len(centres)
            centres.append(pts[i] + f * d)
            radii.append(t.radii[i] + f * (t.radii[i + 1] - t.radii[i]))
            dirs.append(d)
            wts.append((a, b, f))
        joint_row[b] = len(centres) - 1
    last = t.chain[-1]
    if t.tip is not None:
        d = np.asarray(t.tip)
        for s in range(1, t.tip_segments + 1):
            f = s / t.tip_segments
            centres.append(pts[-1] + f * d)
            radii.append(t.radii[-2] + f * (t.radii[-1] - t.radii[-2]))
            dirs.append(d)
            wts.append((last, last, 0.0))
    R, rows = t.ring, len(centres)
    verts, vw = [], []
    for c, r, d, w in zip(centres, radii, dirs, wts):
        u, v = _frame(d)
        for k in range(R):
            a = 2.0 * np.pi * k / R
            verts.append(c + r * (np.cos(a) * u + np.sin(a) * v))
            vw.append(w)
    faces = []
    for row in range(rows - 1):
        for k in range(R):
            a = row * R + k
            b = row * R + (k + 1) % R
            c = (row + 1) * R + k
            d = (row + 1) * R + (k + 1) % R
            faces += [[a, c, b], [b, c, d]]
    start, end = rows * R, rows * R + 1
    verts += [centres[0], centres[-1]]
    vw += [(t.chain[0], t.chain[0], 0.0), (last, last, 0.0)]
    for k in range(R):
        faces.append([start, k, (k + 1) % R])
        faces.append([end, (rows - 1) * R + (k + 1) % R, (rows - 1) * R + k])
    return (np.asarray(verts), np.asarray(faces, np.int64) + v0, vw,
            {j: [v0 + row * R + k for k in range(R)] for j, row in joint_row.items()})


def geometry(tubes: Sequence[Tube] = TUBES) -> Dict[str, np.ndarray]:
    """The layout's template, faces, skinning weights and joint regressor
    (no draws)."""
    J = rest_joints()
    verts, faces, vw, rings = [], [], [], {}
    for t in tubes:
        v, f, w, r = _tube(t, J, sum(len(x) for x in verts))
        verts.append(v)
        faces.append(f)
        vw += w
        for j, ids in r.items():
            rings.setdefault(j, ids)  # a joint's first ring regresses it
    v_template = np.concatenate(verts).astype(np.float32)
    V = v_template.shape[0]
    weights = np.zeros((V, NUM_JOINTS), np.float32)
    for i, (a, b, f) in enumerate(vw):
        weights[i, a] += 1.0 - f
        weights[i, b] += f
    J_regressor = np.zeros((NUM_JOINTS, V), np.float32)
    for j in range(NUM_JOINTS):
        J_regressor[j, rings[j]] = 1.0 / len(rings[j])
    return {"v_template": v_template, "f": np.concatenate(faces).astype(np.uint32),
            "weights": weights, "J_regressor": J_regressor}


def counts(tubes: Sequence[Tube] = TUBES) -> Tuple[int, int]:
    """(vertices, faces) of a layout."""
    g = geometry(tubes)
    return len(g["v_template"]), len(g["f"])


def hand_vertices(tubes: Sequence[Tube] = TUBES) -> int:
    """The vertices of the finger tubes (the hands)."""
    J = rest_joints()
    return sum(len(_tube(t, J, 0)[0]) for t in tubes if t.chain[0] in (20, 21))


def arrays(seed: int, tubes: Sequence[Tube] = TUBES) -> Dict[str, np.ndarray]:
    """The body's arrays in the official SMPL-X ``.npz`` layout, drawn from
    ``seed`` (any whole number)."""
    rng = np.random.RandomState(int(seed) % (2**32))
    out = geometry(tubes)
    V = len(out["v_template"])
    per_joint = rng.randn(NUM_JOINTS, 3, NUM_SHAPE + NUM_EXPRESSION) * SHAPE_STD
    off_face = np.setdiff1d(np.arange(NUM_JOINTS), FACE_JOINTS)
    per_joint[off_face, :, NUM_SHAPE:] = 0.0
    kintree = np.stack([np.asarray(PARENTS, np.int64), np.arange(NUM_JOINTS)])
    kintree[0, 0] = ROOT_PARENT
    out.update(
        shapedirs=np.einsum("vj,jkl->vkl", out["weights"], per_joint).astype(np.float32),
        posedirs=(rng.randn(V, 3, (NUM_JOINTS - 1) * 9) * POSE_STD).astype(np.float32),
        kintree_table=kintree,
        hands_meanl=(rng.randn(45) * HAND_MEAN_STD).astype(np.float32),
        hands_meanr=(rng.randn(45) * HAND_MEAN_STD).astype(np.float32),
    )
    return out


def write(seed: int, tubes: Sequence[Tube] = TUBES, directory: Optional[str] = None) -> str:
    """The body of ``seed`` written as a new ``.npz`` under ``directory``
    (the temporary directory by default); returns its path, which the
    caller removes."""
    fd, path = tempfile.mkstemp(suffix=".npz", dir=directory or tempfile.gettempdir())
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays(seed, tubes))
    return path
