"""Port parity: the logical-axis sharding rules and ZeRO-1's placements.

Every parameter of every *full* config, built on the ``meta`` device
(no allocation), resolves to logical axes of its rank; those axes, the
rules tables of both profiles ("tp", "dp") and the DTensor placements
they give are the reference's, leaf by leaf (the reference's stacked
leaves split onto the port's per-layer names through
``convert._port_leaves``); ZeRO-1 shards m and v on the dimension the
reference's ``zero1_shardings`` picks. The meshes are shapes only
(16 x 16, 2 x 16 x 16 and the 2 x 2 test mesh): no process group is
needed to compare tables.
"""
import functools
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS, get_config as ref_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim.adamw import zero1_shardings  # noqa: E402
from repro.sharding import rules as RR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import zero1_placements  # noqa: E402
from repro_torch.sharding import rules as PR  # noqa: E402

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
PROFILES = ("tp", "dp")


def _port_mesh(shape, names):
    """A stand-in DeviceMesh: the names and sizes the rules read."""
    return types.SimpleNamespace(mesh_dim_names=tuple(names),
                                 mesh=np.empty(shape), ndim=len(shape))


def _ref_mesh(shape, names):
    return AbstractMesh(tuple(shape), tuple(names))


@functools.lru_cache(maxsize=None)
def _meta_params(arch):
    return T.Transformer(get_config(arch), device="meta")


@functools.lru_cache(maxsize=None)
def _ref_axes(arch):
    return RR.param_axes(_ref_params(arch))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(
        lambda: RT.init_params(jax.random.PRNGKey(0), ref_config(arch)))


def _by_port_name(arch, ref_tree, is_leaf=None):
    """{port parameter name: reference leaf} of a tree shaped as the
    reference's parameters: each leaf tagged with its path index, split
    by ``convert._port_leaves``, then looked up."""
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree, is_leaf=is_leaf)
    pflat, tdef = jax.tree_util.tree_flatten_with_path(_ref_params(arch))
    stacked_of = [path[0].key in ("layers", "encoder") for path, _ in pflat]
    tagged = jax.tree_util.tree_unflatten(tdef, [
        np.full(p.shape[:1], i) if st else np.asarray(i)
        for i, ((_, p), st) in enumerate(zip(pflat, stacked_of))])
    leaves = [leaf for _, leaf in flat]
    out = {}
    for name, tag in convert._port_leaves(tagged, get_config(arch)):
        i = int(np.asarray(tag))
        out[name] = (leaves[i], stacked_of[i])
    return out


def _spec_to_placements(spec, names):
    """A reference PartitionSpec as one placement per mesh axis."""
    out = [Replicate()] * len(names)
    for dim, part in enumerate(tuple(spec)):
        if part is None:
            continue
        for ax in (part if isinstance(part, tuple) else (part,)):
            out[names.index(ax)] = Shard(dim)
    return tuple(out)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_cover_every_full_config_param(arch):
    """Every parameter of every full config (on ``meta``: no memory)
    resolves to axes of its rank."""
    params = _meta_params(arch)
    axes = PR.param_axes(params)
    named = dict(params.named_parameters())
    assert set(axes) == set(named)
    for name, p in named.items():
        assert len(axes[name]) == p.dim(), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_reference_leaf_by_leaf(arch):
    """The port's axes of each parameter are the reference's of the leaf
    it comes from, without the stacked layer axis."""
    ref_axes = _ref_axes(arch)
    want = _by_port_name(arch, ref_axes,
                         is_leaf=lambda a: isinstance(a, tuple))
    got = PR.param_axes(_meta_params(arch))
    assert set(got) == set(want)
    for name, (axes, stacked) in want.items():
        assert got[name] == (axes[1:] if stacked else axes), name


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_placements_match_reference(arch, mesh, profile):
    """make_rules gives the reference's table for each profile, mesh and
    batch size, and every parameter's placements are its
    PartitionSpec's."""
    shape, names = MESHES[mesh]
    rcfg, cfg = ref_config(arch), get_config(arch)
    ref_mesh = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, shape)))
    for batch in (None, 1, int(np.prod(shape))):
        assert PR.make_rules(cfg, dict(zip(names, shape)), batch_size=batch,
                             profile=profile) == RR.make_rules(
            rcfg, ref_mesh, batch_size=batch, profile=profile)
    rules = PR.make_rules(cfg, dict(zip(names, shape)), profile=profile)
    pmesh = _port_mesh(shape, names)
    got = PR.param_placements(_meta_params(arch), pmesh, rules)
    ref_axes = _ref_axes(arch)
    want = _by_port_name(arch, ref_axes,
                         is_leaf=lambda a: isinstance(a, tuple))
    for name, (axes, stacked) in want.items():
        spec = RR.logical_to_spec(axes[1:] if stacked else axes, rules)
        assert got[name] == _spec_to_placements(spec, names), name


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_placements_match_reference(arch, profile):
    """m and v take the data axes on the dimension the reference's
    zero1_shardings picks (the first free one the data size divides), on
    the reference's 16 x 16 mesh. A reference leaf stacked over layers
    may take its layer axis; the port has none, so each layer's tensor
    is held to the reference's rule applied to that one layer's leaf
    (its shape and spec without the stacked axis): the same 1/DP of the
    moments, cut within the layer."""
    shape, names = MESHES["16x16"]
    cfg = get_config(arch)
    rules = PR.make_rules(cfg, dict(zip(names, shape)), profile=profile)
    rmesh = _ref_mesh(shape, names)
    ref_params = _ref_params(arch)
    ref_sh = RR.param_shardings(ref_params, rmesh, rules)
    ref_mv = zero1_shardings(ref_sh, rmesh, ref_params)["m"]
    is_sh = lambda s: hasattr(s, "spec")  # noqa: E731
    want = _by_port_name(arch, ref_mv, is_leaf=is_sh)
    shapes = _by_port_name(arch, ref_params)
    params_sh = _by_port_name(arch, ref_sh, is_leaf=is_sh)
    params = _meta_params(arch)
    pmesh = _port_mesh(shape, names)
    got = zero1_placements(PR.param_placements(params, pmesh, rules), pmesh,
                           params)
    assert got["step"] == (Replicate(), Replicate())
    for name, (sh, stacked) in want.items():
        if stacked:
            leaf, _ = shapes[name]
            psh, _ = params_sh[name]
            one = zero1_shardings(
                {"x": NamedSharding(rmesh, P(*tuple(psh.spec)[1:]))}, rmesh,
                {"x": jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)})
            spec = tuple(one["m"]["x"].spec)
            if tuple(sh.spec)[:1] in ((), (None,)):
                assert tuple(sh.spec)[1:] == spec + (None,) * (
                    len(tuple(sh.spec)) - 1 - len(spec)), name
        else:
            spec = tuple(sh.spec)
        assert got["m"][name] == _spec_to_placements(spec, names), name
        assert got["v"][name] == got["m"][name]


def test_logical_to_spec_refuses_a_mesh_axis_twice():
    mesh = _port_mesh((2, 2), ("data", "model"))
    rules = {"a": ("model",), "b": ("model",), "c": ("data", "model")}
    assert PR.logical_to_spec(("a", None), rules, mesh) == (
        Replicate(), Shard(0))
    assert PR.logical_to_spec(("c",), rules, mesh) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="claimed twice"):
        PR.logical_to_spec(("a", "b"), rules, mesh)


def test_annotate_is_a_no_op_outside_a_rules_context():
    """Outside a context (and for a plain tensor inside one) annotate
    returns its input object: inference and one-device training run
    exactly their pre-sharding ops."""
    x = torch.ones(2, 3)
    assert PR.annotate(x, "batch", "embed") is x
    mesh = _port_mesh((2, 2), ("data", "model"))
    with PR.rules_context(mesh, {"batch": ("data",)}):
        assert PR.annotate(x, "batch", "embed") is x
        with PR.rules_context(None, None):
            assert PR._current() is None
        assert PR._current() is not None
    assert PR._current() is None


def test_param_axes_refuse_a_stacked_leaf():
    """The port keeps one module per layer: a leaf of the reference's
    stacked rank has no axes here."""
    with pytest.raises(ValueError, match="rank 4"):
        PR.param_axes({"layers.0.attn.wq.kernel": torch.empty(2, 4, 4, 4)})
    with pytest.raises(ValueError, match="no axis rule"):
        PR.param_axes({"layers.0.nothing": torch.empty(3)})


def test_rules_context_reaches_other_threads():
    """Autograd recomputes a checkpointed region of a CUDA backward on its
    own device thread: the rules must be in force there too."""
    import threading
    mesh = _port_mesh((2, 2), ("data", "model"))
    seen = []
    with PR.rules_context(mesh, {"batch": ("data",)}):
        t = threading.Thread(target=lambda: seen.append(PR._current()))
        t.start()
        t.join(10)
    assert not t.is_alive()
    assert seen[0] is not None and seen[0][1] == {"batch": ("data",)}
