"""The depth render's yardstick: the work of a planar-depth raycast of B
frames of h x w rays against Kc cylinder and Ks sphere slots, whatever
kernels do it, for the render's share of its roofline.

The operations are the ray-primitive tests times :data:`OPS_PER_TEST`,
counted from ``_ray_cylinder`` of ``avoid_mpc_torch/sim/sensors.py`` at
commit a597c63, element by element of its (B, R, K) arithmetic (what is per
ray or per primitive alone is left out): the half-b term, 2 products, a sum
and a doubling (4); the discriminant, b^2 - (4a) c, 2 products and a
difference (3); its clamp and square root (2); each root, a negation, a
sum and a quotient (3 + 3); the nearer root's compare and select (2); the
hit test, 2 compares, an and and a select (4); then in ``render_depth`` the
slot mask's select and the minimum over the slots (2): 23.  Each counts
one operation at the data sheet's float32 rate (``yardstick``), as the SQP
tally counts its compares, selects, quotients and roots.  The bytes are
the least a render moves: the poses and the field read once and the frames
written once.
"""

from __future__ import annotations

import yardstick

OPS_PER_TEST = 4 + 3 + 2 + 3 + 3 + 2 + 4 + 2


def render_counts(tests: int, b: int, h: int, w: int, kc: int, ks: int) -> tuple[int, int]:
    """(operations, bytes) of ``tests`` ray-primitive tests over B frames:
    float32 poses (B, 4, 4); cylinders (B, Kc, 2) + (B, Kc) and spheres
    (B, Ks, 3) + (B, Ks) float32, a bool mask each; frames (B, h, w)
    float32."""
    n_bytes = 4 * b * 16 + b * kc * (4 * 3 + 1) + b * ks * (4 * 4 + 1) + 4 * b * h * w
    return OPS_PER_TEST * tests, n_bytes


def bound_ms(tests: int, b: int, h: int, w: int, kc: int, ks: int) -> tuple[float, str]:
    """The least milliseconds of the render's work, and what bounds it."""
    ops, n_bytes = render_counts(tests, b, h, w, kc, ks)
    return yardstick.bound_ms(n_bytes, ops, yardstick.F32_OPS_PER_S)
