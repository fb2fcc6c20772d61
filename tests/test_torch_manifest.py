"""The port's run manifest (``runtime/manifest.py``) against the JAX
package's ``RunManifest``: the same top-level keys, stage records and
artifact list; the environment block read from torch (``cpu`` here); the
ledger and incarnation blocks; and ``runtime.supervise`` folding its
incarnation history into a manifest the port's child wrote.
"""

import json
import os
import sys

import pytest

from taboo_brittleness_tpu.runtime.manifest import RunManifest as JRunManifest
from taboo_brittleness_tpu_torch.runtime import supervise
from taboo_brittleness_tpu_torch.runtime.manifest import (
    RunManifest, environment_info)
from taboo_brittleness_tpu_torch.runtime.resilience import (
    FailureLedger, RetryPolicy)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _fill(m):
    with m.stage("work", word="ship"):
        pass
    with pytest.raises(RuntimeError):
        with m.stage("boom"):
            raise RuntimeError("x")
    m.add_artifact("results/foo.json")
    m.extra["note"] = "hi"
    return m


#: Blocks written only when their state exists: the preemption margin
#: reads each package's process-wide metrics, which other tests in the
#: same process may have set (tested on their own below and in
#: test_torch_fleet.py).
OPTIONAL = {"preempt_margin_s", "incarnation", "failures", "retries"}


def test_manifest_schema_equals_jax(tmp_path):
    got = _fill(RunManifest(command="test", config={"a": 1}))
    want = _fill(JRunManifest(command="test", config={"a": 1}))
    path = got.save(str(tmp_path / "run_manifest.json"))
    with open(path) as f:
        data = json.load(f)
    assert set(data) - OPTIONAL == set(want.to_dict()) - OPTIONAL
    assert {"run_id", "command", "started_at", "wall_seconds", "environment",
            "config", "stages", "artifacts", "obs", "extra"} <= set(data)
    assert data["command"] == "test" and data["config"] == {"a": 1}
    assert [s["name"] for s in data["stages"]] == ["work", "boom"]
    assert [set(s) for s in data["stages"]] == [set(s) for s in want.stages]
    assert [s["status"] for s in data["stages"]] == ["ok", "error"]
    assert data["stages"][0]["word"] == "ship"
    assert all(s["seconds"] >= 0 for s in data["stages"])
    assert data["artifacts"] == want.artifacts == ["results/foo.json"]
    assert data["extra"] == {"note": "hi"}
    assert set(data["obs"]) >= {"schema_version"}
    assert data["obs"]["schema_version"] == want.to_dict()["obs"][
        "schema_version"]


def test_environment_block_reads_torch_cpu():
    env = environment_info()
    assert env["backend"] == "cpu" and env["devices"] == ["cpu"]
    assert env["torch_version"]
    assert {"python", "platform", "git_commit"} <= set(env)


def test_ledger_and_incarnation_blocks(tmp_path, monkeypatch):
    led = FailureLedger(str(tmp_path))
    led.record_retry("ship", "decode", OSError("x"), 1)
    led.record_quarantine("moon", "decode", OSError("y"), 3)
    m = RunManifest(command="t")
    m.record_resilience(led)
    d = m.to_dict()
    assert set(d["failures"]) == {"moon"} and set(d["retries"]) == {"ship"}
    assert "incarnation" not in d
    monkeypatch.setenv("TBX_INCARNATION", "2")
    assert m.to_dict()["incarnation"] == {"id": 2, "drained": False}


_CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
from taboo_brittleness_tpu_torch.runtime.manifest import RunManifest

out = sys.argv[1]
m = RunManifest(command="child")
with m.stage("work"):
    pass
m.save(os.path.join(out, "run_manifest.json"))
inc = int(os.environ.get("TBX_INCARNATION", "0"))
sys.exit(3 if inc == 0 else 0)
"""


def test_supervise_folds_incarnations_into_the_ports_manifest(tmp_path):
    out = str(tmp_path / "out")
    os.makedirs(out)
    child = tmp_path / "child.py"
    child.write_text(_CHILD.format(repo=REPO))
    res = supervise.supervise(
        [sys.executable, str(child), out], out, max_incarnations=3,
        poll_interval=0.05, grace=1.0, wedge_after=60.0,
        policy=RetryPolicy(max_retries=6, base_delay=0.0),
        env={"TBX_SUPERVISE_BACKOFF_S": "0"})
    assert res.ok, res.to_dict()
    with open(os.path.join(out, "run_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["command"] == "child"
    assert manifest["incarnation"] == {"id": 1, "drained": False}
    inc = manifest["incarnations"]
    assert inc["count"] == 2 and inc["status"] == res.status
    assert [h["outcome"] for h in inc["history"]][0] == "crashed"
