"""The frozen generators give the port's own bursts (``utils/synth.py``)
bit for bit, at a small size, and the same burst for the same seed."""

import numpy as np
import pytest
import torch

from stackbench.gen import bursts


@pytest.mark.parametrize("recipe", ["smooth", "textured"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 1])
def test_equals_port_recipe(recipe, seed):
    from libstacker_tpu_torch.utils import synth

    ours = bursts.RECIPES[recipe](3, 70, 130, seed=seed)
    theirs = {"smooth": synth.make_burst,
              "textured": synth.make_textured_burst}[recipe](
        3, 70, 130, seed=seed)
    assert torch.equal(ours[0], theirs[0])
    assert np.array_equal(ours[1], theirs[1])


def test_pool_seeds_differ_and_repeat():
    seeds = [bursts.burst_seed(2**33 + 1, b) for b in range(4)]
    assert len(set(seeds)) == 4
    assert seeds == [bursts.burst_seed(2**33 + 1, b) for b in range(4)]
    a = bursts.make_burst(2, 40, 60, seed=seeds[0])[0]
    assert torch.equal(a, bursts.make_burst(2, 40, 60, seed=seeds[0])[0])
