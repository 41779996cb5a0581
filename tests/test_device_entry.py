"""Entry-point plumbing that decides where and how the device path runs:
the compile-cache rule, chip_smoke.py's refusal to run without a GPU, the
committed smoke corpus, the single-image backend names and the native
reference build."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import tpujpeg
from tpujpeg import cli
from tpujpeg.io.parser import parse
from tpujpeg.oracle import decoder as oracle
from tpujpeg.pipeline import Geometry, bucket_geometry
from tpujpeg.utils import cache, corpus

from conftest import fixture_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- compile cache ------------------------------------------------------------


def test_compile_cache_dir_env_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV, str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_dir_env_unset(monkeypatch):
    monkeypatch.delenv(cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = cache.compile_cache_dir()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# -- chip_smoke.py refuses to run without a GPU ---------------------------------


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], capture_output=True, text=True,
        timeout=300, env=env, cwd=cwd,
    )


def test_chip_smoke_fails_at_device_check_on_cpu():
    out = _run_smoke(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout
    assert "compile:" not in out.stdout  # stopped before compiling


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# -- committed smoke corpus -----------------------------------------------------


@pytest.mark.parametrize("kind", corpus.KINDS)
def test_corpus_kind_parses(kind):
    datas = corpus.load(kind)
    imgs = [parse(d) for d in datas]
    assert imgs and all(isinstance(d, bytes) for d in datas)
    if kind in ("rst", "norst"):
        assert len(imgs) == corpus.N_DISTINCT
        assert len(set(datas)) == corpus.N_DISTINCT
        assert all((im.width, im.height) == (640, 640) for im in imgs)
        assert all(im.blocks_per_mcu == 3 for im in imgs)  # 4:4:4
    if kind == "rst":
        assert all(im.restart_interval == im.mcus_x for im in imgs)
    if kind in ("norst", "dry_norst"):
        assert all(im.restart_interval == 0 for im in imgs)
    if kind == "big":
        assert (imgs[0].width, imgs[0].height) == (2048, 2048)
        assert imgs[0].mcus_y % 4 == 0  # stripes split evenly over 4 cards
    if kind == "dry_bucket":
        geoms = {Geometry.of(im) for im in imgs}
        assert len(geoms) == 3
        assert len({bucket_geometry(g) for g in geoms}) == 1


def test_corpus_restart_and_plain_encode_same_pixels():
    # the two 640^2 sets are one image set with and without markers
    for a, b in zip(corpus.load("rst")[:2], corpus.load("norst")[:2]):
        np.testing.assert_array_equal(
            tpujpeg.decode(a, backend="cpu"), tpujpeg.decode(b, backend="cpu")
        )


def test_corpus_tile():
    datas = [b"a", b"b", b"c"]
    assert corpus.tile(datas, 7) == [b"a", b"b", b"c", b"a", b"b", b"c", b"a"]
    assert corpus.tile(datas, 2) == [b"a", b"b"]
    with pytest.raises(ValueError):
        corpus.tile([], 4)


def test_corpus_unknown_kind():
    with pytest.raises(ValueError):
        corpus.load("tpu")


# -- backend names --------------------------------------------------------------


def test_decode_backend_device():
    path = fixture_path("3_120x120")
    got = tpujpeg.decode(path, backend="device")
    np.testing.assert_array_equal(
        np.asarray(got), oracle.decode(parse(open(path, "rb").read()))
    )


def test_decode_backend_tpu_rejected():
    with pytest.raises(ValueError, match="unknown backend"):
        tpujpeg.decode(fixture_path("3_120x120"), backend="tpu")


def test_cli_backend_choices(tmp_path, capsys):
    out = tmp_path / "x.array"
    assert cli.main([
        "decode", fixture_path("3_120x120"), "-o", str(out),
        "--backend", "device", "-q",
    ]) == 0
    assert out.exists()
    with pytest.raises(SystemExit):
        cli.main(["decode", fixture_path("3_120x120"), "--backend", "tpu"])


# -- native reference build -----------------------------------------------------


def test_native_build_error_carries_compiler_output(tmp_path):
    from tpujpeg.runtime.native import build

    src = str(tmp_path / "bad.cpp")
    with open(src, "w") as f:
        f.write("this is not C++\n")
    with pytest.raises(RuntimeError, match="native build failed"):
        build._compile(["-shared", "-fPIC"], tmp_path / "bad.so", [src])


def test_native_reports_thread_count():
    from tpujpeg.runtime.native import lib

    assert lib.load().max_threads >= 1
