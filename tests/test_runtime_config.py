"""Runtime set-up that the GPU entry points rely on: the compile cache,
the native library's build stamp, running without pyarrow, and the plan
timing harness (at tiny sizes)."""

import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(code: str, **env):
    full = {"JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", ""),
            "HOME": os.environ.get("HOME", "/tmp"), **env}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       cwd=str(ROOT), env=full, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


_COMPILE_ONE = """
    import os, jax, jax.numpy as jnp
    from arrow_tpu.config import enable_compile_cache
    d = enable_compile_cache()
    jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
    print(d)
"""


def test_compile_cache_honours_env(tmp_path):
    cache = tmp_path / "cache"
    got = _run(_COMPILE_ONE, JAX_COMPILATION_CACHE_DIR=str(cache))
    assert got == str(cache)
    assert any(cache.iterdir()), "no cache entry written"


def test_compile_cache_default_is_fixed_repo_path():
    got = _run(_COMPILE_ONE)
    assert got == str(ROOT / ".jax_cache")
    assert any((ROOT / ".jax_cache").iterdir())


def test_native_build_id_tracks_machine(monkeypatch):
    from arrow_tpu.utils import native
    here = native._build_id()
    assert here == native._build_id()
    monkeypatch.setattr(native.platform, "machine", lambda: "other-arch")
    assert native._build_id() != here


def test_native_library_loads_with_matching_stamp():
    from arrow_tpu.utils import native
    assert native.available()
    assert native._read_stamp() == native._build_id()


def test_column_without_pyarrow():
    out = _run("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "pyarrow":
                    raise ModuleNotFoundError(name)
        sys.meta_path.insert(0, Block())
        import numpy as np
        import arrow_tpu as at
        c = at.column(np.arange(1000))
        assert int(np.asarray(c.values).sum()) == 499500
        assert "pyarrow" not in sys.modules
        print("ok")
    """)
    assert out == "ok"


def test_plan_timings_cases_run_small():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import plan_timings
    finally:
        sys.path.remove(str(ROOT / "tools"))
    recs = plan_timings.run_cases(1, n_filter=4_000, n_group=6_000,
                                  high_groups=2_000, low_groups=16)
    assert [r["case"] for r in recs] == ["filter_table", "packed_group",
                                         "dict_fast", "dict_general"]
    assert recs[0]["kept"] > 0 and recs[1]["groups"] > 1000
    assert all(r["median_s"] > 0 for r in recs)
