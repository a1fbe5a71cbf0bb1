"""The port's copies of the LM half's configs (``repro_torch.configs``,
``repro_torch.models.config.ModelConfig``) against the JAX package's: the
same ten architectures, every ``CONFIG`` and ``SMOKE`` entry field for
field, the same derived sizes and analytic parameter counts."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

ENTRIES = [(a, k) for a in sorted(JARCHS) for k in ("CONFIG", "SMOKE")]


def test_torch_lm_configs_same_architectures():
    assert sorted(TARCHS) == sorted(JARCHS)
    assert [f.name for f in dataclasses.fields(TConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
    assert [f.default for f in dataclasses.fields(TConfig)] == \
        [f.default for f in dataclasses.fields(JConfig)]
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("gpt-5")
    assert tconfigs.get_arch("qwen2-1.5b") is TARCHS["qwen2-1.5b"]


@pytest.mark.parametrize("arch,which", ENTRIES)
def test_torch_lm_configs_entry_matches_reference(arch, which):
    got, want = getattr(TARCHS[arch], which), getattr(JARCHS[arch], which)
    assert isinstance(got, TConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert (got.head_dim, got.d_inner, got.ssm_heads) == \
        (want.head_dim, want.d_inner, want.ssm_heads)


def test_torch_lm_configs_head_dim_default_and_frozen():
    cfg = TConfig(arch_id="x", family="dense", n_layers=1, d_model=96, n_heads=6,
                  n_kv_heads=2, d_ff=8, vocab=10)
    assert cfg.head_dim == 16
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.d_model = 3
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, family="rnn").param_count()
