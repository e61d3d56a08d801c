"""CAS: AMD FidelityFX Contrast-Adaptive Sharpening — dense XLA form.

Reference parity: the `CasFilter` shader entry the reference ships as a
first-class OBS filter (reference Modules/OBS-Plugin/Data/effects/
cas.effect:66 with CAS_SLOW + CAS_BETTER_DIAGONALS defined, kernel math in
ffx_cas_mod.h:47-170) and the host-side `CasSetup` sharpness mapping
(ffx_cas.h:375-394): peak = -1 / lerp(8, 5, saturate(sharpness)).

Per pixel over the 3x3 neighbourhood (a..i around e):
  * soft min/max: cross(b,d,e,f,h) then, with BETTER_DIAGONALS, add the
    full-box min/max — both become 2x-scaled values (ffx_cas_mod.h:84-110).
  * amp = saturate(min(mn, 2 - mx) / mx), shaped by sqrt
    (ffx_cas_mod.h:112-141).
  * w = amp * peak; out = saturate(((b+d+f+h)*w + e) / (4w + 1)), with
    per-channel weights (CAS_SLOW path, ffx_cas_mod.h:158-168).

This is a different kernel from FSR's RCAS (ops/rcas.py): CAS measures
local contrast over the full 3x3 box and shapes the amount with a sqrt,
RCAS is a 5-tap ringing-limited lobe.  Both ship, as in the reference.

A pure 3x3 stencil — eight shifted views of one edge-pad plus elementwise
math, which XLA fuses into one pass over (C, H, W).  The reference's
bit-trick approximate rcp/sqrt (APrxLoRcpF1/APrxLoSqrtF1) are replaced by
division/sqrt; the tolerance tests bound the difference (same call the EASU
port makes, ops/easu.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cas_peak(sharpness: float) -> float:
    """CasSetup's sharpness -> filter peak mapping (ffx_cas.h:389):
    peak = -1 / lerp(8, 5, saturate(sharpness))."""
    s = min(max(float(sharpness), 0.0), 1.0)
    return -1.0 / (8.0 + (5.0 - 8.0) * s)


def cas(img: jax.Array, sharpness: float = 0.8) -> jax.Array:
    """Sharpen (C, H, W) or (H, W) planes in [0, 1]. `sharpness` in [0, 1].

    Border pixels sample the edge-replicated neighbourhood (the reference's
    texture Load clamps at the surface edge).
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]

    e = img
    # Shifted views as unit-stride slices of one edge-pad (XLA fuses them
    # into a single elementwise pass; see ops/rcas.py for the jnp.roll cost
    # note).  Letters follow the reference's 3x3 grid (ffx_cas_mod.h:57-59).
    p = jnp.pad(img, ((0, 0), (1, 1), (1, 1)), mode="edge")
    a = p[:, :-2, :-2]
    b = p[:, :-2, 1:-1]
    c = p[:, :-2, 2:]
    d = p[:, 1:-1, :-2]
    f = p[:, 1:-1, 2:]
    g = p[:, 2:, :-2]
    h = p[:, 2:, 1:-1]
    i = p[:, 2:, 2:]

    # Soft min/max: cross then +box (CAS_BETTER_DIAGONALS, :84-110).  The
    # 2.0 amp numerator below matches the factored-out 2x scale.
    mn = jnp.minimum(jnp.minimum(jnp.minimum(d, e), jnp.minimum(f, b)), h)
    mn2 = jnp.minimum(jnp.minimum(mn, jnp.minimum(a, c)), jnp.minimum(g, i))
    mn = mn + mn2
    mx = jnp.maximum(jnp.maximum(jnp.maximum(d, e), jnp.maximum(f, b)), h)
    mx2 = jnp.maximum(jnp.maximum(mx, jnp.maximum(a, c)), jnp.maximum(g, i))
    mx = mx + mx2

    # amp = saturate(min(mn, 2 - mx) / mx), sqrt-shaped (:119-141).
    amp = jnp.clip(jnp.minimum(mn, 2.0 - mx) / jnp.maximum(mx, 1e-6), 0.0, 1.0)
    amp = jnp.sqrt(amp)

    # Filter: 0 w 0 / w 1 w / 0 w 0, per-channel weights (CAS_SLOW, :158-168).
    w = amp * jnp.float32(cas_peak(sharpness))
    out = ((b + d + f + h) * w + e) / (4.0 * w + 1.0)
    out = jnp.clip(out, 0.0, 1.0)
    return out[0] if squeeze else out
