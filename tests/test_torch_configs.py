"""repro_torch.configs and repro_torch.models.config against the JAX
package's: every architecture's full and smoke configuration, its
parameter counts and the (arch, shape) cells must be equal, and a
reference config carried across with ``model_config_from_reference``
must come back equal."""

import dataclasses

import pytest

import repro.configs as rc
import repro_torch.configs as tc
from repro_torch.convert import model_config_from_reference
from repro_torch.models import ModelConfig, MoEConfig, SSMConfig
from torch_groups import torch_threads  # noqa: F401


@pytest.mark.parametrize("arch", rc.ARCH_NAMES)
def test_config_matches_reference(arch):
    ref, got = rc.get_config(arch), tc.get_config(arch)
    assert isinstance(got, ModelConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()
    assert got.q_rep == ref.q_rep and got.resolved_head_dim == ref.resolved_head_dim
    if ref.moe is not None:
        assert isinstance(got.moe, MoEConfig) and got.moe.padded_experts == ref.moe.padded_experts
    if ref.ssm is not None:
        assert isinstance(got.ssm, SSMConfig)
    smoke_ref, smoke_got = rc.smoke_config(arch), tc.smoke_config(arch)
    assert dataclasses.asdict(smoke_got) == dataclasses.asdict(smoke_ref)
    assert smoke_got.param_count() == smoke_ref.param_count()
    over = dict(d_model=128, dtype="float32")
    assert dataclasses.asdict(tc.smoke_config(arch, **over)) == dataclasses.asdict(
        rc.smoke_config(arch, **over))
    assert tc.arch_shapes(arch) == rc.arch_shapes(arch)
    back = model_config_from_reference(dataclasses.asdict(ref))
    assert back == got


def test_registry_and_cells_match():
    assert tc.ARCH_NAMES == rc.ARCH_NAMES
    assert tc.all_cells() == rc.all_cells()
    assert {k: dataclasses.asdict(v) for k, v in tc.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rc.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_config("nope")
    # the full-width egress gradient of chip_smoke.py phase 3d
    assert tc.get_config("internlm2-1.8b").param_count() == 1_889_107_968
    with pytest.raises(ValueError, match="requires moe"):
        dataclasses.replace(tc.get_config("qwen3-moe-30b-a3b"), moe=None).validate()
