"""The port's config copy and YAML loader against the JAX package's: both
shipped YAML files (``configs/default.yaml`` and the reference's own
``tests/data/reference_mpc_parameters.yaml``) give equal fields in both
packages, and the defaults and derived properties agree."""

import dataclasses
import os

import numpy as np
import pytest

from avoid_mpc_tpu import config as jconfig
from avoid_mpc_torch import config as tconfig

DATA = os.path.join(os.path.dirname(__file__), "data")
YAMLS = {"default": None, "reference": os.path.join(DATA, "reference_mpc_parameters.yaml")}


@pytest.mark.parametrize("name", list(YAMLS))
def test_load_config_equals_jax(name):
    got, want = tconfig.load_config(YAMLS[name]), jconfig.load_config(YAMLS[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got.mpc) is tconfig.MPCConfig and type(got.perception) is tconfig.PerceptionConfig


@pytest.mark.parametrize("cls", ["MPCConfig", "PerceptionConfig", "TaskConfig", "LidarConfig", "EngineConfig"])
def test_defaults_equal_jax(cls):
    got, want = getattr(tconfig, cls)(), getattr(jconfig, cls)()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_derived_properties_equal_jax():
    tp, jp = tconfig.PerceptionConfig(), jconfig.PerceptionConfig()
    np.testing.assert_array_equal(tp.Tbc, jp.Tbc)
    assert (tp.grid_width, tp.grid_height, tp.points_per_frame) == (jp.grid_width, jp.grid_height, 3072)
    tl, jl = tconfig.LidarConfig(), jconfig.LidarConfig()
    assert (tl.points_per_scan, tl.points_per_channel) == (jl.points_per_scan, jl.points_per_channel)
    cfg = tconfig.load_config(YAMLS["reference"])
    assert cfg.mpc.horizon_steps == 30 and cfg.mpc.mpc_max_iter == 3 and cfg.mpc.assoc_m_max == 8192


def test_engine_fields_present():
    names = {f.name for f in dataclasses.fields(tconfig.MPCConfig)}
    for f in ("mpc_max_iter", "safety_distance", "speed", "ttc_threshold", "decay", "con_dt",
              "slow_down_kp", "slow_down_kd", "assoc_radius", "assoc_m_max"):
        assert f in names, f


def test_weights_from_vector_equals_jax():
    w = np.random.default_rng(3).uniform(0.0, 100.0, tconfig.WEIGHTS_DIM)
    got, want = tconfig.MPCWeights.from_vector(w), jconfig.MPCWeights.from_vector(w)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.collide_lambda_omni == 0.0
    np.testing.assert_array_equal(got.as_vector(), w)
    with pytest.raises(ValueError):
        tconfig.MPCWeights.from_vector(w[:-1])
