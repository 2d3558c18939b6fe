"""The port's fleet aggregator (``obs/fleet.py``) held against the JAX
package's over the same two live members on loopback HTTP, one served by
the reference's ``MetricsServer`` and one by the port's: each member's
exposition parses to the same families in both packages, and after the
same scrapes both aggregators render the same merged ``/metrics`` byte
for byte and fold the same ``healthz``, ``leakaudit`` and ``flightrec``
(clocks injected). Malformed expositions are refused whole by both. Then
the CLI's ``--role fleet`` runs as a process over the same two members
and serves the merged view. Modelled on the reference's
``tests/test_fleet.py``."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from grapevine_tpu.obs import fleet as ref_fleet
from grapevine_tpu.obs import httpd as ref_httpd
from grapevine_tpu.obs import leakmon as ref_leakmon
from grapevine_tpu.obs import registry as ref_registry
from grapevine_tpu.obs import workload as ref_workload
from grapevine_tpu_torch.obs import fleet, httpd, leakmon, registry, workload

ROOT = Path(__file__).resolve().parent.parent


def _member(reg_mod, wl_mod, lm_mod, httpd_mod, rounds: int, suspect: bool):
    """A device-owner-like member: rounds and flush counters, the
    workload fill histogram, durable/applied seqs, a leak monitor."""
    reg = reg_mod.TelemetryRegistry()
    reg.counter("grapevine_rounds_total", "rounds").inc(rounds)
    reg.counter("grapevine_evict_flushes_total", "flushes").inc(rounds // 4)
    reg.gauge("grapevine_last_durable_seq", "seq").set(rounds + 2)
    reg.gauge("grapevine_journal_applied_seq", "seq").set(rounds)
    reg.gauge("grapevine_queue_depth", "depth").set(3)
    wl = wl_mod.WorkloadTelemetry(reg, batch_size=8, clock=lambda: 1.0)
    for i in range(rounds):
        wl.observe_round(i % 8 + 1, 8, i % 3, {"round": (0.0, 0.01), "evict": (0.0, 0.004)})
    mon = lm_mod.TranscriptLeakMonitor({"rec": 256}, registry=reg)
    rng = np.random.default_rng(rounds)
    for _ in range(4):
        mon.observe("rec", None, np.zeros(128, np.int64) if suspect
                    else rng.integers(0, 256, 128))
    srv = httpd_mod.MetricsServer(
        reg, health=lambda: (True, {"role": "engine", "slo": {"fast_burn_rate": 0.5,
                                                              "slow_burn_rate": 0.25}}),
        port=0, leakaudit=mon.verdict, flightrec=lambda: {"rounds": [], "capacity": 4})
    return srv, srv.start()


@pytest.fixture(scope="module")
def members():
    a, pa = _member(ref_registry, ref_workload, ref_leakmon, ref_httpd, 20, False)
    b, pb = _member(registry, workload, leakmon, httpd, 24, True)
    yield [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"]
    a.stop()
    b.stop()


def test_member_expositions_parse_equal(members):
    for addr in members:
        body = urllib.request.urlopen(f"http://{addr}/metrics").read().decode()
        fams = fleet.parse_exposition(body)
        assert fams == ref_fleet.parse_exposition(body)
        assert "grapevine_load_batch_fill" in fams and \
            fams["grapevine_load_batch_fill"]["kind"] == "histogram"


@pytest.mark.parametrize("body", [
    "grapevine_x 1\ngrapevine_y{a=\"b\" 2\n",
    "grapevine_x one\n",
    "grapevine_x{a=\"b\"junk} 1\n",
])
def test_malformed_expositions_refused_by_both(body):
    with pytest.raises(ValueError):
        fleet.parse_exposition(body)
    with pytest.raises(ValueError):
        ref_fleet.parse_exposition(body)


def test_aggregators_merge_and_fold_equal(members):
    now = [500.0]
    ours = fleet.FleetAggregator(fleet.FleetConfig(members=tuple(members)),
                                 clock=lambda: now[0])
    theirs = ref_fleet.FleetAggregator(ref_fleet.FleetConfig(members=tuple(members)),
                                       clock=lambda: now[0])
    for _ in range(3):
        ours.scrape_once()
        theirs.scrape_once()
        now[0] += 1.0
        merged = ours.render_merged()
        assert merged == theirs.render_merged()
        assert ours.healthz() == theirs.healthz()
        assert ours.leakaudit() == theirs.leakaudit()
        assert ours.flightrec() == theirs.flightrec()
    assert 'grapevine_rounds_total{shard="0"} 20' in merged
    assert 'grapevine_rounds_total{shard="1"} 24' in merged
    assert 'grapevine_fleet_member_up{shard="1"} 1' in merged
    assert 'grapevine_fleet_journal_lag_seq{shard="0"} 6' in merged
    healthy, detail = ours.healthz()
    assert healthy is True and detail["slo_fast_burn_rate"] == 0.5
    audit = ours.leakaudit()
    assert [m["verdict"] for m in audit["members"]] == ["PASS", "SUSPECT"]
    assert audit["verdict"] == "SUSPECT"


def test_dead_member_degrades_both_alike(members):
    cfg = dict(members=(members[0], "127.0.0.1:1"), scrape_timeout_s=0.5)
    ours = fleet.FleetAggregator(fleet.FleetConfig(**cfg), clock=lambda: 9.0)
    theirs = ref_fleet.FleetAggregator(ref_fleet.FleetConfig(**cfg), clock=lambda: 9.0)
    ours.scrape_once()
    theirs.scrape_once()
    assert ours.render_merged() == theirs.render_merged()
    assert ours.healthz() == theirs.healthz() and ours.healthz()[0] is False
    with pytest.raises(ValueError):
        fleet.FleetConfig(members=())


def test_cli_fleet_role_serves_the_merged_view(members):
    """``--role fleet --fleet-members a,b``: the process scrapes both on its
    cadence and serves the merged ``/metrics``, ``/healthz`` and
    ``/leakaudit`` (503: member 1 is SUSPECT); SIGTERM stops it, exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "grapevine_tpu_torch.server.cli", "--role", "fleet",
         "--fleet-members", ",".join(members), "--fleet-port", "0",
         "--fleet-scrape-interval", "0.2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("grapevine fleet aggregator on port"), \
            line + proc.stderr.read()[-2000:]
        port = int(line.split()[5])
        body = ""
        for _ in range(100):
            body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics").read().decode()
            if 'grapevine_rounds_total{shard="1"}' in body:
                break
            time.sleep(0.1)  # the process scrapes on its own cadence
        assert 'grapevine_rounds_total{shard="0"} 20' in body
        assert 'grapevine_fleet_members 2' in body
        hz = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz").read())
        assert hz["role"] == "fleet" and hz["n_members"] == 2
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/leakaudit")
        assert err.value.code == 503
        assert json.loads(err.value.read())["verdict"] == "SUSPECT"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
