"""The port's config copies equal the JAX registry field by field."""
import dataclasses

import pytest

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models.config import ATTN_KINDS as JAX_ATTN_KINDS
from repro.models.config import MIXER_KINDS as JAX_MIXER_KINDS
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.config import ATTN_KINDS, MIXER_KINDS


def test_registry_and_kinds_match():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert ATTN_KINDS == JAX_ATTN_KINDS
    assert MIXER_KINDS == JAX_MIXER_KINDS


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_fields_and_counts_match(arch, which):
    ours = (get_config if which == "CONFIG" else get_smoke_config)(arch)
    ref = (jax_config if which == "CONFIG" else jax_smoke)(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    for kw in (dict(tokens=4096, training=True, seq_len=2048),
               dict(tokens=4, training=False, kv_len=552)):
        assert ours.flops_parts(**kw) == ref.flops_parts(**kw)


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_qwen2_7b_fits_one_card_in_bf16():
    cfg = get_config("qwen2-7b")
    assert 7.6e9 < cfg.param_count() < 7.7e9
    assert cfg.d_model % 128 == 0 and cfg.resolved_head_dim == 128
