"""L-BFGS with a zoom linesearch, in plain PyTorch: a transcription of
optax 0.2.6's ``optax.lbfgs()`` as ``soar_tpu.preproc.smplify`` calls it.

    lbfgs = LBFGS()                      # memory 10, scaled initial precond.
    state = lbfgs.init(params)           # params: dict of tensors
    for _ in range(steps):
        params, state, value = lbfgs.step(params, state, loss_fn)

- ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``: the
  two-loop recursion over a ring buffer of parameter and gradient
  differences, the initial preconditioner ``<dg, dw> / <dg, dg>``, and on
  the first step ``min(1, 1 / |g|)``;
- ``scale(-1)``;
- ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` with its defaults (``slope_rtol`` 1e-4,
  ``curv_rtol`` 0.9, ``approx_dec_rtol`` 1e-6, ``stepsize_precision``
  1e-5, ``increase_factor`` 2, ``tol`` 0): the interval search and zoom of
  Nocedal and Wright's algorithms 3.5 and 3.6 with the approximate Wolfe
  decrease test of Hager and Zhang, and the safe-step fallback;
- ``value_and_grad_from_state``: a step reuses the linesearch's last value
  and gradient while they are finite.

The parameters are flattened into one vector for the recursion.  The
recursion runs on the parameters' device; the linesearch decides on the
host, in float32 as optax does inside its ``while_loop``: one read of a
(value, slope) pair per function evaluation and of the initial slope per
step.  ``torch.optim.LBFGS`` is another algorithm (history 100, a cubic
interpolation linesearch, other stopping tests).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

f32 = np.float32
INF = f32(np.inf)


# optax.lbfgs()'s settings as SMPLify uses them (memory 10, the scaled
# initial preconditioner) and scale_by_zoom_linesearch's defaults with
# max_linesearch_steps=20.
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
TOL = f32(0.0)
INCREASE_FACTOR = f32(2.0)
SLOPE_RTOL = f32(1e-4)
CURV_RTOL = f32(0.9)
APPROX_DEC_RTOL = f32(1e-6)
STEPSIZE_PRECISION = f32(1e-5)


@dataclasses.dataclass
class LBFGSState:
    count: int
    params: torch.Tensor  # flat parameters of the previous step
    updates: torch.Tensor  # flat gradient of the previous step
    diff_params: torch.Tensor  # [m, n]
    diff_updates: torch.Tensor  # [m, n]
    weights: torch.Tensor  # [m]
    value: np.float32  # the linesearch's last value (inf before the first)
    grad: torch.Tensor  # the linesearch's last gradient
    linesearch_steps: int = 0  # evaluations of the last step's linesearch
    evaluations: int = 0  # function evaluations so far


def flatten(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in params.values()])


def unflatten(flat: torch.Tensor, like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out, i = {}, 0
    for k, v in like.items():
        out[k] = flat[i:i + v.numel()].reshape(v.shape)
        i += v.numel()
    return out


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc**2, -(db**2)], [-(dc**3), db**3]], f32)
    A, B = (d1 @ np.array([fb - fa - C * db, fc - fa - C * dc], f32)) / denom
    radical = B * B - f32(3.0) * A * C
    return f32(a + (-B + np.sqrt(radical)) / (f32(3.0) * A))


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return f32(a - fpa / (f32(2.0) * B))


class LBFGS:
    def init(self, params: Dict[str, torch.Tensor]) -> LBFGSState:
        x = flatten(params).detach()
        m = MEMORY_SIZE
        zeros = torch.zeros((m,) + x.shape, dtype=x.dtype, device=x.device)
        return LBFGSState(count=0, params=torch.zeros_like(x), updates=torch.zeros_like(x),
                          diff_params=zeros, diff_updates=zeros.clone(),
                          weights=torch.zeros(m, dtype=x.dtype, device=x.device),
                          value=INF, grad=torch.zeros_like(x))

    # ------------------------------------------------------------ direction

    def _direction(self, x: torch.Tensor, g: torch.Tensor, state: LBFGSState):
        """``scale_by_lbfgs``: update the memory with (x, g), then return the
        preconditioned gradient P g and the new memory."""
        m = MEMORY_SIZE
        mem_idx, prev_idx = state.count % m, (state.count - 1) % m
        if state.count > 0:
            dw, du = x - state.params, g - state.updates
            vdot = torch.dot(du, dw)
            weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
        else:
            dw, du = torch.zeros_like(x), torch.zeros_like(g)
            weight = torch.zeros((), dtype=x.dtype, device=x.device)
        dps, dus, rhos = state.diff_params.clone(), state.diff_updates.clone(), state.weights.clone()
        dps[prev_idx], dus[prev_idx], rhos[prev_idx] = dw, du, weight

        if state.count > 0:
            num, den = torch.dot(du, dw), torch.sum(du * du)
            scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
        else:
            scale = torch.clamp_max(1.0 / torch.linalg.norm(g), 1.0)

        idxs = [(mem_idx + j) % m for j in range(m)]
        vec, alphas = g, [None] * m
        for j in reversed(range(m)):
            i = idxs[j]
            alphas[j] = rhos[i] * torch.dot(dps[i], vec)
            vec = vec + (-alphas[j]) * dus[i]
        vec = scale * vec
        for j in range(m):
            i = idxs[j]
            beta = rhos[i] * torch.dot(dus[i], vec)
            vec = vec + (alphas[j] - beta) * dps[i]
        return vec, (dps, dus, rhos)

    # ----------------------------------------------------------- linesearch

    def _linesearch(self, evaluate, value_init, slope_init, grad):
        """``zoom_linesearch`` from stepsize 1: returns (stepsize, value,
        grad, evaluations).  ``evaluate(stepsize) -> (value, grad, slope)``."""

        def decrease_error_of(stepsize, value_step, slope_step):
            err = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
            approx = slope_step - (f32(2.0) * SLOPE_RTOL - f32(1.0)) * slope_init
            delta = value_step - value_init - APPROX_DEC_RTOL * np.abs(value_init)
            err = np.maximum(np.minimum(np.maximum(approx, delta), err), f32(0.0))
            return INF if np.isnan(err) else f32(err)

        def curvature_error_of(slope_step):
            err = np.maximum(np.abs(slope_step) - CURV_RTOL * np.abs(slope_init), f32(0.0))
            return INF if np.isnan(err) else f32(err)

        count = 0
        stepsize, value, g, slope = f32(0.0), value_init, grad, slope_init
        decrease_error = curvature_error = INF
        interval_found = done = failed = False
        low, value_low, slope_low = f32(0.0), value_init, slope_init
        high, value_high, slope_high = f32(0.0), value_init, slope_init
        cubic_ref, value_cubic_ref = f32(0.0), value_init
        safe_stepsize, safe_value, safe_grad = f32(0.0), value_init, grad

        while not (done or failed):
            if not interval_found:  # Nocedal and Wright, algorithm 3.5
                new = f32(1.0) if count == 0 else INCREASE_FACTOR * stepsize
                new_value, new_grad, new_slope = evaluate(new)
                decrease_error = decrease_error_of(new, new_value, new_slope)
                curvature_error = curvature_error_of(new_slope)
                new_error = max(decrease_error, curvature_error)
                if decrease_error <= TOL:
                    safe_stepsize, safe_value, safe_grad = new, new_value, new_grad
                set_high = (decrease_error > 0.0) or (new_value >= value and count > 0)
                set_low = (new_slope >= 0.0) and not set_high
                if set_low:
                    low, value_low, slope_low = new, new_value, new_slope
                    high, value_high, slope_high = stepsize, value, slope
                else:
                    low, value_low, slope_low = stepsize, value, slope
                    high, value_high, slope_high = new, new_value, new_slope
                interval_found = set_high or set_low or new_error <= TOL
                done = bool(new_error <= TOL)
                failed = (count + 1 >= MAX_LINESEARCH_STEPS) and not done
                cubic_ref, value_cubic_ref = low, value_low
                stepsize, value, g, slope = new, new_value, new_grad, new_slope
            else:  # algorithm 3.6
                delta = np.abs(high - low)
                left, right = min(high, low), max(high, low)
                cubic_chk, quad_chk = f32(0.2) * delta, f32(0.1) * delta
                too_small = delta <= STEPSIZE_PRECISION
                with np.errstate(all="ignore"):
                    mid_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                          cubic_ref, value_cubic_ref)
                    mid_quad = _quadmin(low, value_low, slope_low, high, value_high)
                use_cubic = bool((mid_cubic > left + cubic_chk) & (mid_cubic < right - cubic_chk))
                use_quad = (not use_cubic) and bool((mid_quad > left + quad_chk)
                                                    & (mid_quad < right - quad_chk))
                if use_cubic:
                    middle = mid_cubic
                elif use_quad:
                    middle = mid_quad
                else:
                    middle = f32((low + high) / f32(2.0))
                v_mid, g_mid, s_mid = evaluate(middle)
                decrease_error = decrease_error_of(middle, v_mid, s_mid)
                curvature_error = curvature_error_of(s_mid)
                new_error = max(decrease_error, curvature_error)
                if decrease_error <= TOL and v_mid < safe_value:
                    safe_stepsize, safe_value, safe_grad = middle, v_mid, g_mid
                done = bool(new_error <= TOL)
                set_high_mid = (decrease_error > 0.0) or (v_mid >= value_low)
                set_high_low = (s_mid * (high - low) >= 0.0) and not set_high_mid
                new_high = (middle, v_mid, s_mid) if set_high_mid else (high, value_high, slope_high)
                if set_high_low:
                    new_high = (low, value_low, slope_low)
                if set_high_mid or set_high_low:
                    cubic_ref, value_cubic_ref = high, value_high
                else:
                    cubic_ref, value_cubic_ref = low, value_low
                if not set_high_mid:
                    low, value_low, slope_low = middle, v_mid, s_mid
                high, value_high, slope_high = new_high
                presumably_failed = (count + 1 >= MAX_LINESEARCH_STEPS) or (
                    too_small and safe_stepsize > 0.0)
                failed = presumably_failed and not done
                stepsize, value, g, slope = middle, v_mid, g_mid, s_mid
            count += 1
            if failed and (safe_stepsize > 0.0 or np.isinf(decrease_error)):
                stepsize, value, g = safe_stepsize, safe_value, safe_grad
        return stepsize, value, g, count

    # ----------------------------------------------------------------- step

    def step(
        self,
        params: Dict[str, torch.Tensor],
        state: LBFGSState,
        loss_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    ) -> Tuple[Dict[str, torch.Tensor], LBFGSState, np.float32]:
        """One optimizer step; returns (new params, new state, the loss at
        ``params``)."""
        x = flatten(params).detach()
        evaluations = [state.evaluations]

        def value_and_grad(flat):
            flat = flat.detach().requires_grad_(True)
            with torch.enable_grad():
                v = loss_fn(unflatten(flat, params))
                (grad,) = torch.autograd.grad(v, flat)
            evaluations[0] += 1
            return v.detach(), grad

        if np.isfinite(state.value):
            value, grad = state.value, state.grad
        else:
            v, grad = value_and_grad(x)
            value = f32(v.item())

        direction, (dps, dus, rhos) = self._direction(x, grad, state)
        updates = -direction

        def evaluate(stepsize):
            v, gr = value_and_grad(x + float(stepsize) * updates)
            pair = torch.stack([v, torch.dot(gr, updates)]).cpu().numpy()
            return f32(pair[0]), gr, f32(pair[1])

        slope_init = f32(torch.dot(updates, grad).item())
        lr, ls_value, ls_grad, n_ls = self._linesearch(evaluate, value, slope_init, grad)
        new_x = x + float(lr) * updates
        new_state = LBFGSState(count=state.count + 1, params=x, updates=grad, diff_params=dps,
                               diff_updates=dus, weights=rhos, value=ls_value,
                               grad=ls_grad, linesearch_steps=n_ls, evaluations=evaluations[0])
        return unflatten(new_x, params), new_state, value


def run(params: Dict[str, torch.Tensor], loss_fn, steps: int
        ) -> Tuple[Dict[str, torch.Tensor], List[float], List[int]]:
    """``steps`` steps from ``params``; returns (params, the loss at the start
    of each step, the function evaluations of each step)."""
    opt = LBFGS()
    state = opt.init(params)
    values, evaluations = [], []
    for _ in range(steps):
        before = state.evaluations
        params, state, value = opt.step(params, state, loss_fn)
        values.append(float(value))
        evaluations.append(state.evaluations - before)
    return params, values, evaluations
