"""The port's Config copy (partisan_tpu_torch/config.py) against
partisan_tpu/config.py: the same fields, types and defaults, and the same
mapping and OS-env tiers."""

import dataclasses

import pytest

from partisan_tpu import config as ref
from partisan_tpu_torch import config

ENVIRONS = [
    {},
    {"PEER_SERVICE": "partisan_hyparview_peer_service_manager"},
    {"PEER_SERVICE": "scamp", "TAG": "client", "REPLAY": "1"},
    {"PEER_SERVICE": "false", "TAG": "false", "REPLAY": "false",
     "SHRINKING": "false"},
    {"SHRINKING": "yes", "TRACE_FILE": "/tmp/trace.bin"},
    {"TRACE_FILE": ""},
]


def as_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_fields_and_defaults_match():
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(ref.Config)]
    got = [(f.name, f.type, f.default)
           for f in dataclasses.fields(config.Config)]
    assert got == want
    assert as_dict(config.DEFAULT) == as_dict(ref.DEFAULT)
    assert config._MANAGER_ALIASES == ref._MANAGER_ALIASES
    with pytest.raises(dataclasses.FrozenInstanceError):
        config.DEFAULT.n_nodes = 3


@pytest.mark.parametrize("environ", ENVIRONS)
def test_env_overrides_match(environ):
    assert config.env_overrides(environ) == ref.env_overrides(environ)


@pytest.mark.parametrize("environ", ENVIRONS)
@pytest.mark.parametrize("mapping", [None, {"n_nodes": 256, "seed": 9},
                                     {"shuffle_interval": 4, "tag": "srv"}])
def test_from_mapping_matches(mapping, environ):
    kw = {"max_active_size": 5}
    got = config.from_mapping(mapping, environ=environ, **kw)
    want = ref.from_mapping(mapping, environ=environ, **kw)
    assert as_dict(got) == as_dict(want)


def test_replace_and_channel_helpers_match():
    kw = dict(n_nodes=1 << 20, channels=("a", "b", "c"), seed=11)
    got, want = config.Config().replace(**kw), ref.Config().replace(**kw)
    assert as_dict(got) == as_dict(want)
    assert got.n_channels == want.n_channels == 3
    assert got.channel_index("b") == want.channel_index("b") == 1
    with pytest.raises(TypeError):
        config.from_mapping({"no_such_field": 1}, environ={})


def test_use_pallas_route_is_refused():
    """The port always takes its routing kernels on the card: the
    reference's opt-in flag would select nothing, so True raises."""
    assert not config.Config().use_pallas_route
    with pytest.raises(ValueError, match="use_pallas_route=True"):
        config.Config(use_pallas_route=True)
    with pytest.raises(ValueError, match="use_pallas_route=True"):
        config.DEFAULT.replace(use_pallas_route=True)
    with pytest.raises(ValueError, match="use_pallas_route=True"):
        config.from_mapping({"use_pallas_route": True}, environ={})
