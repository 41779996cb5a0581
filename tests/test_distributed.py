"""Multi-process distributed decode plumbing, exercised for real.

Round-1 shipped `parallel/distributed.py` without ever running it with
process_count > 1.  These tests launch an actual
2-process jax.distributed cluster on CPU (coordinator + worker over
localhost) and verify work sharding is disjoint+covering and the metrics
reduction sums across hosts — plus the fixed initialize() semantics: a
configured-but-broken coordinator must raise, never silently fall back to
standalone duplicate work.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tpujpeg.parallel import distributed as dist

    pid = int(sys.argv[1])
    dist.initialize(
        coordinator_address={addr!r},
        num_processes=2,
        process_id=pid,
        local_device_ids=[0],
        initialization_timeout=60,
    )
    idx, cnt = dist.process_info()
    assert cnt == 2, cnt
    assert idx == pid, (idx, pid)

    items = list(range(10))
    mine = dist.shard_list(items)
    assert mine == items[pid::2], mine

    totals = dist.allreduce_metrics(
        {{"images": len(mine), "value_sum": float(sum(mine))}}
    )
    assert totals["images"] == 10, totals
    assert totals["value_sum"] == 45.0, totals
    dist.barrier()
    print(f"proc{{pid}} OK {{mine}}")
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_shard_and_allreduce(tmp_path):
    addr = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO, addr=addr))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # no forced multi-device: one CPU per proc
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out}"
        assert f"proc{i} OK" in out, out
    # disjoint + covering shards, printed by the workers themselves
    assert "[0, 2, 4, 6, 8]" in outs[0]
    assert "[1, 3, 5, 7, 9]" in outs[1]


@pytest.mark.slow
def test_configured_coordinator_failure_raises(tmp_path):
    # A coordinator IS configured but unreachable: initialize must raise
    # (exit nonzero), not degrade to standalone — silent fallback meant
    # every host decoding the full list.
    script = tmp_path / "bad.py"
    script.write_text(
        textwrap.dedent(
            f"""
            import sys
            sys.path.insert(0, {REPO!r})
            import jax
            jax.config.update("jax_platforms", "cpu")
            from tpujpeg.parallel import distributed as dist
            try:
                dist.initialize(
                    coordinator_address="127.0.0.1:9",  # discard port
                    num_processes=2,
                    process_id=1,
                    initialization_timeout=5,
                )
            except Exception:
                print("RAISED-AS-REQUIRED")
                sys.exit(0)
            print("SILENT-FALLBACK-BUG count=", jax.process_count())
            sys.exit(1)
            """
        )
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-u", str(script)],  # -u: the client may abort
        # the interpreter right after our print; unbuffered keeps it
        capture_output=True,
        text=True,
        timeout=240,
        env=env,
    )
    # The contract: a configured-but-broken coordinator must fail LOUDLY.
    # Two acceptable shapes: (a) initialize() raises and our handler prints
    # the marker; (b) the XLA distributed client hard-aborts the process
    # from its heartbeat thread before Python sees the error (observed on
    # jax 0.9: "Terminating process ... DEADLINE_EXCEEDED").  What must
    # NEVER happen is the silent standalone fallback.
    assert "SILENT-FALLBACK-BUG" not in out.stdout, out.stdout
    loud = "RAISED-AS-REQUIRED" in out.stdout or (
        out.returncode != 0
        and ("Terminating process" in out.stderr or "DEADLINE" in out.stderr)
    )
    assert loud, (out.returncode, out.stdout, out.stderr)


def test_unconfigured_runs_standalone(monkeypatch):
    # no kwargs, no env: standalone by construction
    from tpujpeg.parallel import distributed as dist

    for v in dist._COORDINATOR_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    assert not dist.coordinator_configured()
    dist.initialize()  # must be a no-op, not an error
    idx, cnt = dist.process_info()
    assert cnt >= 1 and idx == 0


def test_shard_list_explicit_indices():
    from tpujpeg.parallel import distributed as dist

    items = list(range(7))
    shards = [dist.shard_list(items, index=i, count=3) for i in range(3)]
    flat = sorted(x for s in shards for x in s)
    assert flat == items  # covering
    assert all(len(set(s)) == len(s) for s in shards)  # disjoint
