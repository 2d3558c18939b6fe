"""The capacity model: a saturation knee over the SLO burn-rate signal
(port of ``grapevine_tpu/load/capacity.py``; numpy only).

The ramp schedule (generators.ramp_to_saturation) declares a staircase
of offered rates; the replay (harness.ScenarioRunner) yields per-op
enqueue→settle latencies. This module grades each declared step against
the commit-latency SLO the engine gates on (obs/slo.py semantics:
a round/op *breaches* past the target; the *burn rate* is the breach
fraction over the error budget) and reports the **knee** — the highest
offered rate at which the SLO still held — which is the repo's banked
capacity number (BOLT, arXiv:2509.01742,
reports its oblivious-map capacity as exactly this swept-load
saturation throughput).

Knee semantics, deliberately conservative:

- a step *holds* when its burn rate is ≤ ``burn_limit`` (default 1.0 —
  spending within the error budget) AND almost none of its ops failed
  or timed out (``fail_limit``; a step that "holds" latency by failing
  ops has not held anything). Achieved throughput — completions inside
  the step's wall window — is *reported* but never gates: once commit
  latency approaches the step length, completions inside window k
  belong to arrivals from earlier steps, so a throughput floor would
  systematically fail healthy low-rate steps;
- the knee is the LAST holding step *before the first failing step* —
  a lucky later step on a noisy host must not inflate capacity past a
  measured failure;
- when no step fails the ramp never saturated: the knee is reported as
  the last step's rate with ``saturated: false`` — a lower bound, and
  the caller should ramp higher.
"""

from __future__ import annotations

import numpy as np

from .generators import Schedule


def step_stats(offered_rate: float, step_s: float, latencies_s,
               ok, target_ms: float, error_budget: float,
               achieved_count: int | None = None) -> dict:
    """Grade one ramp step: breach fraction, burn rate, percentiles.

    ``achieved_count`` is the number of ops that COMPLETED inside the
    step's window (analyze_ramp computes it from settle times). Without
    it the fallback counts the step's arrivals that eventually
    succeeded — which under overload equals the arrival rate (every op
    settles *sometime*) and overstates throughput at saturation; pass
    the real count whenever settle times exist."""
    lat = np.asarray(latencies_s, float)
    ok = np.asarray(ok, bool)
    settled = lat[~np.isnan(lat)]
    n = len(lat)
    n_settled = len(settled)
    breaches = int(np.sum(settled > target_ms / 1e3)) + int(
        np.sum(np.isnan(lat))  # an op that never settled breached
    )
    breach_frac = breaches / n if n else 0.0
    n_done = int(np.sum(ok)) if achieved_count is None else int(
        achieved_count)
    # ops that failed outright or never settled (ok is only set on an
    # accepted response) — the non-latency way a step stops holding
    fail_frac = (n - int(np.sum(ok))) / n if n else 0.0
    out = {
        "offered_rate": round(float(offered_rate), 1),
        "n_ops": n,
        # the rate the Poisson draw actually realized this step — the
        # fair baseline for the achieved-throughput check (a sparse
        # draw must not read as the server failing to keep up)
        "arrival_rate": round(n / step_s, 1) if step_s else 0.0,
        "achieved_ops_per_sec": round(
            n_done / step_s, 1) if step_s else 0.0,
        "breach_fraction": round(breach_frac, 4),
        "burn_rate": round(breach_frac / error_budget, 2),
        "failure_fraction": round(fail_frac, 4),
    }
    if n_settled:
        out["p50_commit_ms"] = round(
            float(np.percentile(settled, 50, method="higher")) * 1e3, 2)
        out["p99_commit_ms"] = round(
            float(np.percentile(settled, 99, method="higher")) * 1e3, 2)
    return out


def find_knee(steps: list[dict], burn_limit: float = 1.0,
              fail_limit: float = 0.1, min_ops: int = 8) -> dict:
    """The saturation knee over graded steps (offered-rate order)."""
    knee = None
    first_fail = None
    for s in steps:
        if s["n_ops"] < min_ops:
            continue  # insufficient evidence grades nothing (the
            # leakmon min-samples stance)
        holds = (
            s["burn_rate"] <= burn_limit
            and s.get("failure_fraction", 0.0) <= fail_limit
        )
        if holds and first_fail is None:
            knee = s
        elif not holds:
            first_fail = s
            break
    return {
        "knee_ops_per_sec": knee["offered_rate"] if knee else 0.0,
        "knee_p99_commit_ms": knee.get("p99_commit_ms") if knee else None,
        "saturated": first_fail is not None,
        "first_failing_rate": (
            first_fail["offered_rate"] if first_fail else None),
        "burn_limit": burn_limit,
    }


def analyze_ramp(schedule: Schedule, result, target_ms: float,
                 error_budget: float = 0.01,
                 burn_limit: float = 1.0) -> dict:
    """Grade a ramp replay step by declared step and find the knee.

    LATENCY and breach accounting attribute ops to the step their
    *arrival* was scheduled in (an op admitted at rate r whose latency
    explodes is r's breach, even if it settles two steps later).
    THROUGHPUT counts completions inside the step's wall window
    regardless of arrival step — under overload arrivals always settle
    eventually, so counting a step's arrivals-that-succeeded would
    report the arrival rate, not what the server sustained. Offered
    rates are converted to wall terms by the replay's time_scale so
    the knee is in real ops/s.
    """
    steps_meta = schedule.meta.get("steps")
    if not steps_meta:
        raise ValueError("schedule has no declared ramp steps")
    scale = result.time_scale
    # settle time relative to the replay start, wall seconds (latency
    # is anchored at submit ≈ the scaled scheduled arrival)
    settle_wall = schedule.t_s * scale + result.latency_s
    graded = []
    for sm in steps_meta:
        in_step = (schedule.t_s >= sm["t0"]) & (schedule.t_s < sm["t1"])
        done_in_step = (
            result.ok
            & ~np.isnan(result.latency_s)
            & (settle_wall >= sm["t0"] * scale)
            & (settle_wall < sm["t1"] * scale)
        )
        graded.append(step_stats(
            offered_rate=sm["offered_rate"] / scale,
            step_s=(sm["t1"] - sm["t0"]) * scale,
            latencies_s=result.latency_s[in_step],
            ok=result.ok[in_step],
            target_ms=target_ms,
            error_budget=error_budget,
            achieved_count=int(np.sum(done_in_step)),
        ))
    knee = find_knee(graded, burn_limit=burn_limit)
    return {
        "target_ms": round(float(target_ms), 1),
        "error_budget": error_budget,
        "steps": graded,
        **knee,
    }


def fleet_capacity(shard_analyses: list[dict]) -> dict:
    """Fold N per-shard ramp analyses (``analyze_ramp`` output, shard
    order) into the fleet grade.

    The declared partition serves disjoint recipient spaces, so shard
    knees ADD into the fleet knee — but only while every shard holds:
    the fleet is ``saturated`` as soon as ANY shard saturates (one hot
    shard past its knee is a capacity failure the sum must not paper
    over; the sum reported for a saturated fleet is still the additive
    lower bound of the holding knees). Keyed by ``shard_count`` so an
    N=2 number never grades against the N=1 series."""
    if not shard_analyses:
        raise ValueError("need at least one shard analysis")
    return {
        "shard_count": len(shard_analyses),
        "fleet_knee_ops_per_sec": round(
            sum(a["knee_ops_per_sec"] for a in shard_analyses), 1),
        "saturated": any(a["saturated"] for a in shard_analyses),
        "shards": [
            {
                "shard": i,
                "knee_ops_per_sec": a["knee_ops_per_sec"],
                "knee_p99_commit_ms": a.get("knee_p99_commit_ms"),
                "saturated": a["saturated"],
            }
            for i, a in enumerate(shard_analyses)
        ],
    }
