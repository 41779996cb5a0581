"""On-card smoke test: the batched device decode end to end on one GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: batch + stripe sharding only

Phases (one card), each printed on its own lines:
  1. device check: a GPU backend, the card's name and power limit, and
     the native C++ decoder built from source (the comparison reference);
  2. compile the fused chunk program (128 x 640^2) cold, with its
     memory analysis and the compile-cache directory;
  3. the 384-image restart corpus through BatchDecoder(backend="fsm"),
     every image bit-exact against the native decoder, four against the
     NumPy oracle, and no host fallback in BatchStats;
  4. the same images without restart markers (speculative device path);
  5. one 2048^2 image through tpujpeg.decode(backend="device");
  6. the colour-conversion proof on the compiled kernel (--stride 8);
  7. informational warm wall times and the link probe's reading.

The corpus is the committed corpus/smoke/ (tools/build_smoke_corpus.py),
tiled to batch size.  Any failed check exits non-zero before the last
line; on success the last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 384
CHUNK = 128
ORACLE_SAMPLES = (0, 133, 266, 383)   # one image from each chunk, and the last
COLOR_STRIDE = 8


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAILED: {msg}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_check(n_devices: int):
    import jax

    backend = jax.default_backend()
    check(backend == "gpu", f"no GPU: JAX backend is {backend!r}")
    devs = jax.devices()
    check(len(devs) >= n_devices,
          f"need {n_devices} GPU(s), JAX sees {len(devs)}")
    say(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    card = card_line()
    say(card)
    return devs, card


def build_native() -> None:
    """The native decoder is the reference for the whole corpus: it must
    build here, from source, and load (no silent oracle fallback)."""
    from tpujpeg.runtime import host
    from tpujpeg.runtime.native import build

    t0 = time.perf_counter()
    build.build(force=True)
    native = host._load_native()
    check(native is not None, "native C++ decoder failed to load")
    say(f"native decoder: built and loaded in {time.perf_counter() - t0:.1f} s, "
        f"{native.max_threads} OpenMP thread(s)")


def native_refs(datas: list[bytes]) -> list[np.ndarray]:
    import tpujpeg

    return [tpujpeg.decode(d, backend="cpu") for d in datas]


def check_batch(name: str, out, refs: list[np.ndarray]) -> None:
    check(out is not None and len(out) == BATCH,
          f"{name}: expected {BATCH} outputs")
    for i, o in enumerate(out):
        ref = refs[i % len(refs)]
        check(o is not None and o.shape == ref.shape and np.array_equal(o, ref),
              f"{name}: image {i} differs from the native decoder")
    say(f"{name}: {BATCH}/{BATCH} images bit-exact against the native decoder")


def check_stats(name: str, stats, backend_ok) -> None:
    parts = stats.backend.split("+")
    check(all(backend_ok(p) for p in parts),
          f"{name}: chunks ran on {stats.backend!r}")
    check(stats.fsm_envelope_fallbacks == 0,
          f"{name}: {stats.fsm_envelope_fallbacks} envelope fallbacks")
    check(stats.fsm_malformed_fallbacks == 0,
          f"{name}: {stats.fsm_malformed_fallbacks} malformed fallbacks")
    check(stats.failures == {}, f"{name}: failures {stats.failures}")
    say(f"{name}: backend={stats.backend} chunks={stats.chunks} "
        f"fsm_k_retries={stats.fsm_k_retries} "
        f"spec_sync_misses={stats.spec_sync_misses} "
        f"repaired_pixels={stats.repaired_pixels}")


def compile_phase(rst: list[bytes]) -> None:
    import jax.numpy as jnp

    from tpujpeg.io.parser import parse
    from tpujpeg.ops import fsm
    from tpujpeg.pipeline import Geometry
    from tpujpeg.runtime import fused

    imgs = [parse(d) for d in rst[:CHUNK]]
    geom = Geometry.of(imgs[0])
    plan = fsm.build_plan(imgs, split=False)
    xs, sn = plan.groups[0]
    quant = np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs
    ]).astype(np.int32)
    fn = fused.compiled_fused_decoder(
        geom, plan.tables, plan.max_blk, plan.layout, CHUNK
    )
    t0 = time.perf_counter()
    compiled = fn.lower(
        jnp.asarray(xs), jnp.asarray(sn), jnp.asarray(quant)
    ).compile()
    dt = time.perf_counter() - t0
    say(f"compile: fused chunk program {CHUNK} x {geom.width}x{geom.height}: "
        f"lanes={xs.shape[0]} stride={xs.shape[1]} max_blk={plan.max_blk} "
        f"cold compile {dt:.1f} s")
    ma = compiled.memory_analysis()
    say("compile: memory_analysis " + json.dumps({
        k: int(getattr(ma, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes",
        ) if hasattr(ma, k)
    }))


def batch_phase(name: str, datas: list[bytes], distinct: list[bytes],
                backend_ok, oracle_check: bool = True):
    from tpujpeg.io.parser import parse
    from tpujpeg.oracle import decoder as oracle
    from tpujpeg.runtime.batch import BatchDecoder

    dec = BatchDecoder(backend="fsm", chunk_size=CHUNK, strict=True)
    t0 = time.perf_counter()
    out = dec.decode(datas)
    say(f"{name}: first decode (compiles included) "
        f"{time.perf_counter() - t0:.1f} s")
    check_batch(name, out, native_refs(distinct))
    if oracle_check:
        for i in ORACLE_SAMPLES:
            check(np.array_equal(out[i], oracle.decode(parse(datas[i]))),
                  f"{name}: image {i} differs from the oracle")
        say(f"{name}: images {list(ORACLE_SAMPLES)} bit-exact against the "
            "oracle")
    check_stats(name, dec.stats, backend_ok)
    return dec


def run_one() -> dict:
    devs, card = device_check(1)

    from tpujpeg.utils import corpus
    from tpujpeg.utils.cache import compile_cache_dir

    say(f"compile cache: {compile_cache_dir()}")
    build_native()

    rst_distinct = corpus.load("rst")
    norst_distinct = corpus.load("norst")
    rst = corpus.tile(rst_distinct, BATCH)
    norst = corpus.tile(norst_distinct, BATCH)
    say(f"corpus: {BATCH} x 640^2 restart "
        f"({sum(map(len, rst)) / 1e6:.1f} MB compressed), {BATCH} no-restart "
        f"({sum(map(len, norst)) / 1e6:.1f} MB)")

    compile_phase(rst)
    dec_rst = batch_phase("restart", rst, rst_distinct,
                          lambda b: b == "fsm")
    dec_norst = batch_phase("no-restart", norst, norst_distinct,
                            lambda b: b.startswith("fsm-spec"))

    import tpujpeg

    big = corpus.load("big")[0]
    got = tpujpeg.decode(big, backend="device")
    check(np.array_equal(got, tpujpeg.decode(big, backend="cpu")),
          "2048^2 device decode differs from the native decoder")
    say(f"single image: {got.shape[1]}x{got.shape[0]} via "
        "tpujpeg.decode(backend='device') bit-exact against the native decoder")

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from check_color_device import prove

    proof = prove(COLOR_STRIDE, log=lambda m: None)
    check(proof["unflagged_mismatches"] == 0,
          f"colour proof: unflagged mismatch {proof['first_unflagged']}")
    say(f"colour proof (stride {COLOR_STRIDE}): checked={proof['checked']} "
        f"flagged={proof['flagged_share']:.5%} unflagged=0")

    from tpujpeg.runtime import batch

    mbps = batch.measured_link_mbps()
    slow = mbps < batch._LINK_MBPS_FSM_THRESHOLD
    say(f"link probe: {mbps:.0f} MB/s host->device->host; backend='auto' "
        f"would pick {'fsm' if slow else 'host'}, build_plan split={slow}")
    for name, dec, datas in (("restart", dec_rst, rst),
                             ("no-restart", dec_norst, norst)):
        t0 = time.perf_counter()
        dec.decode(datas)
        say(f"timing (informational): warm {name} batch of {BATCH} "
            f"{(time.perf_counter() - t0) * 1e3:.0f} ms wall, "
            f"fetch and repair included, on {card}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def run_four() -> dict:
    import jax

    devs, _ = device_check(4)
    check(len(devs) == 4, f"--four needs exactly 4 GPUs, JAX sees {len(devs)}")

    from tpujpeg.io.parser import parse
    from tpujpeg.ops import fsm
    from tpujpeg.parallel import sharding
    from tpujpeg.runtime.batch import BatchDecoder
    from tpujpeg.utils import corpus
    from tpujpeg.utils.cache import compile_cache_dir

    say(f"compile cache: {compile_cache_dir()}")
    build_native()
    rst_distinct = corpus.load("rst")
    rst = corpus.tile(rst_distinct, BATCH)

    dec = BatchDecoder(backend="fsm", chunk_size=CHUNK, strict=True)
    check(dec.mesh.devices.size == 4, "BatchDecoder mesh is not 4 devices")
    t0 = time.perf_counter()
    out = dec.decode(rst)
    say(f"four-card batch: decode {time.perf_counter() - t0:.1f} s "
        "(compiles included)")
    check_batch("four-card batch", out, native_refs(rst_distinct))
    check_stats("four-card batch", dec.stats, lambda b: b == "fsm")
    for d in devs:
        stats = d.memory_stats() or {}
        say(f"four-card batch: device {d.id} bytes_in_use="
            f"{stats.get('bytes_in_use')}")
    plan = fsm.build_plan([parse(d) for d in rst[:CHUNK]])
    per_lane, _ = fsm.decode_plan(plan)
    say("four-card batch: FSM scan output lives on "
        f"{sorted(d.id for d in per_lane.devices())}; pixel program sharded "
        f"over batch on {sorted(d.id for d in devs)}")

    import tpujpeg

    big = corpus.load("big")[0]
    got = sharding.decode_striped(parse(big), n_stripes=4)
    check(np.array_equal(got, tpujpeg.decode(big, backend="cpu")),
          "striped 2048^2 decode differs from the native decoder")
    say(f"four-card stripes: {got.shape[1]}x{got.shape[0]} decoded as 4 "
        "MCU-row stripes (all_gather) bit-exact against the native decoder")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(jax.devices())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharding phase")
    args = ap.parse_args()
    device = run_four() if args.four else run_one()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
