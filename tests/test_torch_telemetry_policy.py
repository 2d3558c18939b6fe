"""The telemetry policy gate (``analysis/check_telemetry_policy.py``)
against the reference tool (``tools/check_telemetry_policy.py``): the
static scan flags what the reference's flags, at the same ``file:line``;
each of the eight registry audits counts the families and series the
reference's counts; a forbidden key is refused by a port registry; the
span allowlist admits the facade's declared stages and no other name; the
gate exits 0 where ``import jax`` fails."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
from test_torch_census_posmap import reference_tool

from grapevine_tpu_torch.analysis import check_telemetry_policy as ctp
from grapevine_tpu_torch.obs import tracer
from grapevine_tpu_torch.obs.tracer import STAGE_SPANS
from grapevine_tpu_torch.obs.phases import PHASES
from grapevine_tpu_torch.obs.registry import (
    FORBIDDEN_LABEL_KEYS,
    TelemetryLeakError,
    TelemetryRegistry,
)
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LEAKY = '''from somewhere import REG, m

m.labels(op_type="read").inc()
m.observe(0.5,
          recipient=b"x")
REG.counter("grapevine_x_total", "help", labels={"client_id": ("0",)})
'''


@pytest.fixture(scope="module")
def ref():
    return reference_tool("check_telemetry_policy")


def test_the_port_scans_clean(ref, monkeypatch):
    assert ctp.scan_call_sites() == []
    # the reference's scan over the port's tree agrees
    monkeypatch.setattr(ref, "PKG", os.path.join(REPO, "grapevine_tpu_torch"))
    monkeypatch.setattr(ref, "REPO", REPO)
    assert ref.scan_call_sites() == []


def test_a_seeded_violation_is_flagged_at_its_line(tmp_path, ref, monkeypatch):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "leaky.py").write_text(LEAKY)
    got = ctp.scan_call_sites(str(pkg))
    assert got == [
        "pkg/leaky.py:3: telemetry call passes forbidden label key 'op_type'",
        "pkg/leaky.py:4: telemetry call passes forbidden label key 'recipient'",
        "pkg/leaky.py:6: metric registration declares forbidden label key 'client_id'",
    ]
    monkeypatch.setattr(ref, "PKG", str(pkg))
    monkeypatch.setattr(ref, "REPO", str(tmp_path))
    assert sorted(ref.scan_call_sites()) == sorted(got)
    assert ctp.main(["--root", str(pkg)]) == 1


def test_the_forbidden_keys_are_the_ports_own(ref):
    assert set(ctp._forbidden()) == set(FORBIDDEN_LABEL_KEYS) == set(ref._FORBIDDEN)


@pytest.mark.parametrize("key", sorted(FORBIDDEN_LABEL_KEYS))
def test_a_forbidden_key_is_refused_by_a_port_registry(key):
    with pytest.raises(TelemetryLeakError):
        TelemetryRegistry().counter("grapevine_probe_total", "probe", labels={key: ("0",)})


#: audit -> the report keys it shares with the reference's
AUDITS = {
    "audit_shipped_registry": ("metrics", "series"),
    "audit_leakmon_registry": ("leakmon_families", "metrics", "series"),
    "audit_trace_slo_registry": ("trace_slo_families", "metrics", "series"),
    "audit_workload_registry": ("workload_families", "metrics", "series"),
    "audit_evict_registry": ("metrics", "series"),
    "audit_fleet_registry": ("fleet_families", "metrics", "series"),
    "audit_cost_registry": ("cost_families", "metrics", "series"),
    "audit_host_registry": ("host_families", "metrics", "series"),
}


@pytest.mark.parametrize("audit", sorted(AUDITS))
def test_each_audit_counts_what_the_reference_counts(audit, ref):
    port, want = getattr(ctp, audit)(), getattr(ref, audit)()
    assert {k: port[k] for k in AUDITS[audit]} == {k: want[k] for k in AUDITS[audit]}


def test_the_telemetry_gate_admits_exactly_the_declared_stages(monkeypatch):
    """The policy gate passes with the stages declared, and flags a name
    outside the phases, the two windows and STAGE_SPANS."""
    assert tracer.ALLOWED_SPAN_NAMES == \
        set(PHASES) | {"device", "round"} | set(STAGE_SPANS)
    ctp.audit_trace_slo_registry()
    monkeypatch.setattr(tracer, "ALLOWED_SPAN_NAMES",
                        tracer.ALLOWED_SPAN_NAMES | {"launch_op_read"})
    with pytest.raises(ctp.PolicyViolation, match="launch_op_read"):
        ctp.audit_trace_slo_registry()


def test_a_namespace_rule_is_enforced():
    """A key the registry allows (``tree``) is still refused in a
    namespace that admits only ``phase``, on a live registry too."""
    reg = TelemetryRegistry()
    reg.gauge("grapevine_cost_probe", "probe", labels={"tree": ("rec", "mb")})
    with pytest.raises(ctp.PolicyViolation, match="grapevine_cost_probe"):
        ctp.check_namespace(reg, "grapevine_cost_")
    with pytest.raises(ctp.PolicyViolation):
        ctp.audit_live_registry(reg)


def test_a_live_engine_registry_passes():
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.obs import attach_round_observability

    eng = GrapevineEngine(GrapevineConfig(max_messages=64, max_recipients=8, batch_size=4),
                          device="cpu")
    try:
        attach_round_observability(eng, eng.metrics.registry)
        rep = ctp.audit_live_registry(eng.metrics.registry)
    finally:
        eng.close()
    assert {"grapevine_trace_", "grapevine_slo_", "grapevine_load_",
            "grapevine_cost_"} <= set(rep["namespaces"])


def test_main_exits_zero_without_jax():
    code = ("import sys, runpy\nsys.modules['jax'] = None\n"
            "sys.argv = ['check_telemetry_policy']\n"
            "runpy.run_module('grapevine_tpu_torch.analysis.check_telemetry_policy', "
            "run_name='__main__')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "[check_telemetry_policy] PASS" in p.stdout
    assert "static scan clean" in p.stdout
