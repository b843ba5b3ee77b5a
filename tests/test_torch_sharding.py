"""Port vs JAX: the sharding rules, the modules' logical axes and the
optimizer state's, and the meshes — shapes only, no processes
(the collectives: tests/test_torch_distributed.py).

Every registered config, at full width (the port's model on the ``meta``
device, JAX's through ``jax.eval_shape``) and reduced, in FP, QAT and packed
form: the port's ``param_axes()`` equal JAX's mapped through the bridge (a
stacked leaf's leading ``"layers"`` dropped and given to each layer), as
do ``AdamW.state_axes`` in fp32 and ``int8_blockwise``.  On five meshes,
each leaf's spec and its fallbacks equal JAX's leaf for leaf (JAX's
``PartitionSpec`` read as one tuple of mesh axes per dim; ``"layers"`` is
never sharded, so dropping it changes no other dim).  Then the cases of
tests/test_sharding.py, held to JAX's plan and to that file's expectations.
Everything is exact: the rules are integer logic.
"""
import jax
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs  # noqa: F401  (registers every config)
from repro.core import quant as JQ
from repro.distributed.sharding import ShardingPlan as JPlan
from repro.distributed.sharding import default_rules as jrules
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.training import optimizer as JO
from repro_torch.bridge import _flatten, torch_axes_from_jax
from repro_torch.core import quant as TQ
from repro_torch.distributed import sharding as TS
from repro_torch.launch import mesh as TM
from repro_torch.models import build_model, get_config
from repro_torch.models.base import _REGISTRY
from repro_torch.training import optimizer as TO
from repro_torch.training.trainer import jax_ranks

NAMES = sorted({c.name for c in jconfigs.ASSIGNED + jconfigs.PAPER_BACKBONES})
MESHES = [{"data": 2, "model": 4}, {"data": 1, "model": 8},
          {"pod": 2, "data": 2, "model": 2}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]
QUANT = {"fp": (JQ.FP, TQ.FP), "qat": (JQ.QAT, TQ.QAT),
         "packed": (JQ.QuantConfig(mode="packed"), TQ.QuantConfig(mode="packed"))}


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _jplan(shape):
    return JPlan(FakeMesh(shape), jrules("pod" in shape))


def _tplan(shape):
    return TS.ShardingPlan(dict(shape), TS.default_rules("pod" in shape))


def _per_dim(spec, ndim):
    """A JAX PartitionSpec as the port's spec: one tuple of axes per dim."""
    dims = [() if e is None else ((e,) if isinstance(e, str) else tuple(e))
            for e in tuple(spec)]
    return tuple(dims + [()] * (ndim - len(dims)))


def _pair(name, reduced, quant, shapes=False):
    """(JAX model, its param shapes if asked, port config, port model on
    ``meta``)."""
    jq, tq = QUANT[quant]
    jcfg, cfg = jget(name).with_quant(jq), get_config(name).with_quant(tq)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jm = jbuild(jcfg)
    jshapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))) if shapes else None
    return jm, jshapes, cfg, build_model(cfg, device="meta")


def test_every_registered_config_is_tested():
    assert sorted(_REGISTRY) == NAMES


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_param_and_state_axes_match_jax(name, reduced):
    for quant in QUANT:
        jm, _, cfg, model = _pair(name, reduced, quant)
        jaxes = jm.param_axes()
        axes = model.param_axes()
        assert axes == torch_axes_from_jax(cfg, jaxes), quant
        ranks = jax_ranks(dict(model.state_dict()))
        for dtype in ("float32", "int8_blockwise"):
            jst = JO.AdamW(JO.AdamWConfig(state_dtype=dtype)).state_axes(jaxes)
            st = TO.AdamW(TO.AdamWConfig(state_dtype=dtype)).state_axes(axes, ranks)
            assert st.step == jst.step == ()
            for part in ("m", "v"):
                assert getattr(st, part) == torch_axes_from_jax(
                    cfg, getattr(jst, part)), (quant, dtype, part)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_specs_and_fallbacks_match_jax(name, reduced):
    """Each leaf resolved alone (its own fallbacks) on each mesh; the
    whole-tree walk (``tree_specs``) gives the same specs and, as a
    multiset, the same fallbacks as the leaves one by one."""
    for quant in ("fp", "qat"):
        jm, shapes, cfg, model = _pair(name, reduced, quant, shapes=True)
        jaxes = _flatten(jm.param_axes())
        jshapes = _flatten(shapes)
        sd = model.state_dict()
        taxes = model.param_axes()
        paths = _port_paths(cfg, jaxes)
        for mesh in MESHES:
            want = {}
            for path, ax in jaxes.items():
                jp = _jplan(mesh)
                spec = _per_dim(jp.spec(ax, jshapes[path].shape), len(ax))
                stacked = ax[:1] == ("layers",)
                want[path] = (spec[1:] if stacked else spec, jp.fallbacks)
            # each port leaf against its JAX leaf (a stacked leaf: every layer)
            got_fallbacks = []
            for key, path in paths.items():
                tp = _tplan(mesh)
                spec = tp.spec(taxes[key], sd[key].shape)
                assert (spec, tp.fallbacks) == want[path], (quant, mesh, key)
                got_fallbacks += tp.fallbacks
            tp = _tplan(mesh)
            assert tp.tree_specs(taxes, sd) == {
                k: want[paths[k]][0] for k in taxes}
            assert sorted(tp.fallbacks) == sorted(got_fallbacks)


def _port_paths(cfg, jaxes):
    """{port tensor name: the JAX leaf path it comes from}."""
    out = {}
    for path in jaxes:
        one = {}
        node = one
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = ("layers",) if jaxes[path][:1] == ("layers",) else ()
        for key in torch_axes_from_jax(cfg, one):
            out[key] = path
    return out


# -- the cases of tests/test_sharding.py ---------------------------------------------

SHARDING_CASES = {
    # name: (multi_pod, logical, shape, JAX test's expected per-dim spec)
    "ffn_weight_fsdp_plus_tp": (False, ("embed", "mlp"), (1024, 2816),
                                (("data",), ("model",))),
    "vocab_fallback_when_indivisible": (False, ("vocab", "embed"), (49155, 1024),
                                        ((), ("data",))),
    "kv_heads_divisible": (False, ("embed", "kv_heads"), (4096, 8 * 128),
                           (("data",), ("model",))),
    "kv_heads_fallback_to_kv_seq": (False, ("batch", "kv_seq", "kv_heads", "head_dim"),
                                    (128, 32768, 8, 128),
                                    (("data",), ("model",), (), ())),
    "batch_prefers_pod_data": (True, ("batch", "seq"), (256, 4096),
                               (("pod", "data"), ())),
    "batch_of_one_replicates": (True, ("batch", "kv_seq", "kv_heads", "head_dim"),
                                (1, 524288, 8, 128), ((), ("model",), (), ())),
    "no_axis_used_twice": (False, ("heads", "mlp"), (1024, 2816),
                           (("model",), ())),
    "priority_heads_beat_kvseq": (False, ("batch", "kv_seq", "kv_heads", "head_dim"),
                                  (128, 32768, 16, 64),
                                  (("data",), (), ("model",), ())),
}


@pytest.mark.parametrize("case", sorted(SHARDING_CASES))
def test_sharding_cases_match_jax(case):
    multi_pod, logical, shape, want = SHARDING_CASES[case]
    mesh = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    jp, tp = _jplan(mesh), _tplan(mesh)
    got = tp.spec(logical, shape)
    assert got == _per_dim(jp.spec(logical, shape), len(shape)) == want
    assert tp.fallbacks == jp.fallbacks
    if case == "vocab_fallback_when_indivisible":
        assert any("vocab" in f for f in tp.fallbacks)
    used = [a for axes in got for a in axes]
    assert len(set(used)) == len(used)


def test_tree_specs_structure():
    tp = _tplan({"data": 16, "model": 16})
    axes = {"w": ("embed", "mlp"), "norm": {"scale": ("embed",)},
            "m": TO.Moment8(("embed", "mlp"), ("embed", None))}
    shapes = {"w": torch.empty(64, 32, device="meta"),
              "norm": {"scale": torch.empty(64, device="meta")},
              "m": TO.Moment8(torch.empty(64, 32, device="meta"),
                              torch.empty(64, 1, device="meta"))}
    specs = tp.tree_specs(axes, shapes)
    assert specs["w"] == (("data",), ("model",))
    assert specs["norm"]["scale"] == (("data",),)
    assert specs["m"] == TO.Moment8((("data",), ("model",)), (("data",), ()))


def test_constrain_noop_without_plan():
    assert TS.get_plan() is None
    x = torch.ones((4, 4))
    assert TS.constrain(x, ("batch", "seq")) is x
    TS.set_plan(_tplan({"data": 2, "model": 2}))
    try:
        assert TS.constrain(x, ("batch", "seq")) is x      # a plain tensor
    finally:
        TS.set_plan(None)


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    tp = _tplan({"pod": 2, "data": 16, "model": 16})
    assert tp.placements((("pod", "data"), (), ("model",))) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tp.placements(((), ("data",))) == [Replicate(), Shard(1), Replicate()]


def test_meshes():
    assert TM.make_production_mesh() == {"data": 16, "model": 16}
    assert TM.make_production_mesh(multi_pod=True) == \
        {"pod": 2, "data": 16, "model": 16}
    assert TM.world_size() == 1
    for args, msg in (((2, 1), "mesh 1x2x1=2 needs 2 ranks"),
                      ((1, 2, 2), "mesh 2x1x2=4 needs 4 ranks")):
        with pytest.raises(ValueError, match=msg):
            TM.make_mesh(*args)
    with pytest.raises(ValueError, match="1x1x16=16"):
        TM.largest_feasible_mesh()


def test_moe_groups_that_would_straddle_ranks_raise():
    """The sharded step splits the batch's tokens over the batch's ranks;
    an MoE layer's groups must then be the whole batch's (granite reduced:
    ``moe_group_size`` 64)."""
    from repro_torch.training.trainer import check_moe_groups
    model = build_model(get_config("granite-moe-1b-a400m").reduced(), device="meta")
    check_moe_groups(model, 8 * 16, 2)        # 2 groups of 64, one a rank
    check_moe_groups(model, 8 * 12, 1)        # not split
    with pytest.raises(ValueError, match="96 tokens form 1 MoE groups"):
        check_moe_groups(model, 8 * 12, 2)
