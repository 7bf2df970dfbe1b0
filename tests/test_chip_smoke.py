"""chip_smoke.py on a machine without a GPU, and the compile-cache helper.

The GPU phases themselves run only on the card (``python chip_smoke.py``);
here the CPU checks that the script refuses to run without one, leaves
JAX's configuration alone when imported, and that its helpers measure
what they claim.
"""

import importlib
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from ptam_cg_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_config_alone():
    before = dict(jax.config.values)
    sys.modules.pop("chip_smoke", None)
    importlib.import_module("chip_smoke")
    assert dict(jax.config.values) == before


def test_device_gate_refuses_cpu():
    import chip_smoke
    with pytest.raises(SystemExit) as exc:
        chip_smoke.device_gate()
    assert exc.value.code not in (None, 0)
    assert "needs a GPU" in str(exc.value.code)


@pytest.mark.parametrize("argv", [[], ["--chips", "4"]])
def test_main_exits_nonzero_without_result_on_cpu(argv, capsys):
    import chip_smoke
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (None, 0)
    assert '"ok"' not in capsys.readouterr().out


def test_rotation_angle_is_exact_near_zero():
    import chip_smoke
    from ptam_cg_tpu.utils import se3 as se3lib
    angles = np.array([0.0, 1e-7, 1e-4, 0.3])
    Rb = np.stack([np.asarray(se3lib.so3_exp(np.array([0.0, 0.0, a],
                                                      np.float32)))
                   for a in angles]).astype(np.float64)
    Ra = np.broadcast_to(np.eye(3), Rb.shape)
    got = chip_smoke.rotation_angle(Ra, Rb)
    np.testing.assert_allclose(got, angles, rtol=1e-5, atol=1e-9)


def test_lm_agreement_check_rejects_a_different_iteration_count():
    from __graft_entry__ import ba_problem, check_lm_agreement
    from ptam_cg_tpu.models import bundle
    prob, _ = ba_problem(4, 64, 256)
    st = bundle.init_lm(prob)._replace(last_error=np.float32(3.0))
    d = check_lm_agreement(st, st, 2, 2)
    assert d["cam_diff"] == 0.0 and d["outlier_agreement"] == 1.0
    with pytest.raises(AssertionError):
        check_lm_agreement(st, st, 2, 3)


def test_default_cache_dir_is_fixed_and_gitignored():
    assert compile_cache.DEFAULT_DIR == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("env", [None, "", "/some/cache"])
def test_enable_compile_cache_sets_only_the_default(env, monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if not env:
        if env is None:
            monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(compile_cache.ENV_VAR, env)
        assert compile_cache.enable_compile_cache() == str(
            compile_cache.DEFAULT_DIR)
        assert calls == [("jax_compilation_cache_dir",
                          str(compile_cache.DEFAULT_DIR))]
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env)
        assert compile_cache.enable_compile_cache() == env
        assert calls == []
