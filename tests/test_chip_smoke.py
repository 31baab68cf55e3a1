"""chip_smoke.py's phases at tiny sizes on the CPU, each against its
numpy reference, and its refusal to run without a GPU."""

import subprocess
import sys
import textwrap

import pytest

import chip_smoke as cs

SIZES = cs.Sizes(fact=30_000, dim=3_000, parquet=7_000, small=12_000,
                 k1_groups=4_000, k2_groups=60)


@pytest.fixture(scope="module")
def ctx():
    return cs.phase_ingest(SIZES, seed=3)


@pytest.mark.parametrize("phase", [cs.phase_filter, cs.phase_sort,
                                   cs.phase_group_by, cs.phase_join,
                                   cs.phase_sql])
def test_phase_matches_numpy(ctx, phase):
    phase(ctx)


def test_phase_cast_cmp():
    cs.phase_cast_cmp(5_000, seed=3)


def test_phase_op_audit():
    cs.phase_op_audit(2_000, seed=3)


def test_phase_multi_on_four_virtual_devices():
    cs.phase_multi(cs.MultiSizes(rows=40_000, keys=3_000, build=4_000,
                                 dict_size=50), seed=3, n_dev=4)


def test_reference_checks_catch_a_wrong_answer(ctx):
    """The comparisons fail on a corrupted result (not vacuous)."""
    import numpy as np
    with pytest.raises(cs.SmokeFailure):
        cs._equal(np.array([1.0, -0.0]), np.array([1.0, 0.0]), "signed 0")
    with pytest.raises(cs.SmokeFailure):
        cs._check_stable_order(np.array([1, 1, 0]), np.array([1, 0, 2]),
                               "tie order")
    with pytest.raises(cs.SmokeFailure):
        cs._float_sums_close(np.array([1.0]), np.array([1.1]),
                             np.array([1.0]), "sum")


def test_main_without_gpu_exits_nonzero(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert "no GPU found" in out.err
    assert '"ok"' not in out.out


def test_phases_need_no_pyarrow(tmp_path):
    """The smoke's path runs with pyarrow unimportable."""
    script = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "pyarrow":
                    raise ModuleNotFoundError(name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(cs.__file__.rsplit('/', 1)[0])!r})
        import numpy as np
        import arrow_tpu as at
        assert len(at.column(np.arange(10))) == 10
        import chip_smoke as cs
        sizes = cs.Sizes(fact=4_000, dim=500, parquet=1_000, small=2_000,
                         k1_groups=600, k2_groups=20)
        ctx = cs.phase_ingest(sizes, 1)
        for phase in (cs.phase_filter, cs.phase_sort, cs.phase_group_by,
                      cs.phase_join, cs.phase_sql):
            phase(ctx)
        cs.phase_cast_cmp(1_000, 1)
        cs.phase_op_audit(500, 1)
        assert "pyarrow" not in sys.modules
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600,
                       env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
                            "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
