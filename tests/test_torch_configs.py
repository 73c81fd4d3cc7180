"""The port's config registry against ``repro.configs``: the same eleven
architectures, each config and its reduction field for field, the
analytic parameter counts, ``d_inner`` / ``ssm_heads``, ``SHAPES`` and
``supports_shape``. All exact."""
import dataclasses

import pytest

from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget_config
from repro.configs import list_archs as rlist_archs
from repro_torch.configs import SHAPES, get_config, list_archs

ARCHS = rlist_archs()


def test_registry_lists_repros_archs():
    assert list_archs() == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_repros(arch):
    for reduced in (False, True):
        got = get_config(arch, reduced=reduced)
        want = rget_config(arch, reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.d_inner, got.ssm_heads) == (want.d_inner, want.ssm_heads)
        for shape in RSHAPES:
            assert got.supports_shape(shape) == want.supports_shape(shape)
    kw = dict(quantization="ternary", num_layers=2)
    assert dataclasses.asdict(get_config(arch, reduced=True, **kw)) == \
        dataclasses.asdict(rget_config(arch, reduced=True, **kw))


def test_shapes_equal_repros():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RSHAPES.items()}


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="registered"):
        get_config("no-such-arch")
