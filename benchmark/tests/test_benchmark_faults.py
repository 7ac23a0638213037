"""A run whose timed path is broken underneath comes out not correct: the
whole run on the CPU at a tiny size, past the look for a card, once for
each fault the cell can have (one card, so no exchange between cards)."""

import pytest
import torch

import run
import tiny


def solve_unchanged(inputs, us, xs, conv, obs):
    return inputs[3], xs, conv, obs  # the warm start handed back as the solution


def half_batch(inputs, us, xs, conv, obs):
    h = us.shape[0] // 2  # the second half left out: its warm start handed back unsolved
    us = us.clone()
    us[h:] = inputs[3][h:]
    return us, xs, conv, obs


def association_altered(inputs, us, xs, conv, obs):
    obs = obs.clone()
    obs[0, 0, 0, 0] += 0.5
    return us, xs, conv, obs


def states_altered(inputs, us, xs, conv, obs):
    return us, inputs[0][:, None].expand_as(xs), conv, obs  # a predicted path that never leaves its start


def map_unchanged(inputs, frame, m, out):
    return frame, inputs[3], out  # the frame never reaches the map


def solve_altered(inputs, frame, m, out):
    return frame, m, out._replace(u_cmd=out.u_cmd + 0.01, cost=out.cost * 1.001)  # the engine's answer, altered


def command_altered(inputs, frame, m, out):
    return frame, m, out._replace(u_cmd=out.u_cmd + 0.01)  # the command alone, altered where it is produced


def decision_flipped(inputs, frame, m, out):
    return frame, m, out._replace(is_safety=~out.is_safety)  # the engine's safety decision, flipped


FAULTS = [
    ("mc_batch_4096.forest", solve_unchanged),
    ("mc_batch_4096.forest", half_batch),
    ("mc_batch_4096.forest", association_altered),
    ("mc_batch_4096.forest", states_altered),
    ("single_robot_640x480.onboard", map_unchanged),
    ("single_robot_640x480.onboard", solve_altered),
    ("single_robot_640x480.onboard", command_altered),
    ("single_robot_640x480.onboard", decision_flipped),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    out = run.execute(cell, 4_242_424_242, 0.5, False, torch.device("cpu"), scale=tiny.scale(cell, fault=fault))
    assert not out["correct"], out["compared"]
