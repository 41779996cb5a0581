"""Smoke tests for the driver-facing entry points.

bench.py must always print one valid JSON line and __graft_entry__ must
expose entry()/dryrun_multichip — these are executed by automation, so a
regression here is worse than a failing unit test.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_emits_one_json_line():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [
            sys.executable, os.path.join(REPO, "bench.py"),
            "--images", "2", "--chunk", "2", "--chunk-e2e", "2",
            "--iters", "1", "--skip-runtime", "--one-corpus",
        ],
        capture_output=True, text=True, timeout=1200, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.strip().splitlines() if l.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    # format contract only — the tiny CPU smoke config rounds rates to 0
    for key in ("metric", "value", "unit", "vs_baseline", "bits_per_px",
                "device_mpixels_per_s", "e2e_mpixels_per_s", "corpus",
                "platform", "device_kind", "device_count", "card"):
        assert key in rec, rec.get("error", key)
    assert rec["value"] >= 0
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    assert rec["stage_breakdown_s"]["entropy"] >= 0


def test_graft_entry_single_chip():
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    rgb, risk = out
    assert rgb.shape[0] == 3  # planar [3, H, W] device layout
