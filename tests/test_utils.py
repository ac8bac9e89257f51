"""Profiling/tracing/debug utilities (SURVEY.md §5 aux subsystems)."""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from smatcher.utils import PhaseTimer, time_jit, emit_jsonl, dprint


def test_phase_timer_accumulates():
    pt = PhaseTimer()
    with pt.phase("read"):
        time.sleep(0.01)
    with pt.phase("read"):
        time.sleep(0.01)
    with pt.phase("scan"):
        pass
    r = pt.report()
    assert set(r) == {"read_s", "scan_s"}
    assert r["read_s"] >= 0.02
    assert r["scan_s"] >= 0.0


def test_time_jit_reports_rate():
    f = jax.jit(lambda x: jnp.sum(x * 2))
    x = jnp.arange(1 << 16, dtype=jnp.int32)
    r = time_jit(f, x, reps=3, bytes_scanned=x.size * 4)
    assert r["reps"] == 3
    assert r["best_s"] > 0 and r["bytes_per_s"] > 0
    assert r["mean_s"] >= r["best_s"]


def test_emit_jsonl(tmp_path):
    p = tmp_path / "metrics.jsonl"
    emit_jsonl(str(p), {"matches": 1})
    emit_jsonl(str(p), {"matches": 2})
    recs = [json.loads(l) for l in p.read_text().splitlines()]
    assert recs == [{"matches": 1}, {"matches": 2}]


def test_dprint_in_jit(capfd):
    def f(x):
        dprint("v={}", x[0])
        return x + 1
    np.testing.assert_array_equal(jax.jit(f)(jnp.arange(3)), [1, 2, 3])
    jax.effects_barrier()
    assert "v=0" in capfd.readouterr().out


def test_dprint_in_pallas_interpret(capfd):
    from jax.experimental import pallas as pl

    dispatched = []
    orig = pl.debug_print

    def spy(fmt, *args):
        dispatched.append(fmt)
        return orig(fmt, *args)

    def kern(x_ref, o_ref):
        dprint("cell={}", x_ref[0, 0])
        o_ref[:] = x_ref[:] * 3

    pl.debug_print = spy
    try:
        out = pl.pallas_call(
            kern, grid=(1,),
            in_specs=[pl.BlockSpec((8, 128), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
            backend="triton", interpret=True)(jnp.ones((8, 128), jnp.int32))
    finally:
        pl.debug_print = orig
    assert int(out.sum()) == 3 * 8 * 128
    assert dispatched, "dprint must route to pl.debug_print inside kernels"
    jax.effects_barrier()
    assert "cell=" in capfd.readouterr().out


def test_top_level_scan():
    import smatcher as ts
    from smatcher.core import datagen
    ab = ts.Alphabet.dna()
    text = datagen.generate_text(30_000, ab, seed=71)
    pats = datagen.generate_patterns(text, 30, 8, ab, seed=72)
    r = ts.scan(text, pats, engine="fast", backend="xla", tile=1 << 12)
    assert r["matches"] == datagen.count_matches(text, pats)
    assert r["bytes"] == 30_000 and r["bytes_per_s"] > 0
    r2 = ts.scan(text, pats, engine="wm", tile=1 << 12)
    assert r2["matches"] == r["matches"]


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the helper returns it and configures
    nothing else (JAX reads the variable itself)."""
    import jax
    from smatcher.utils.cache import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Unset: the cache is .jax_cache/ at the checkout root, which
    .gitignore lists."""
    import os
    import jax
    from smatcher.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(cache.ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.exists(os.path.join(cache.ROOT, "smatcher"))
        with open(os.path.join(cache.ROOT, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
