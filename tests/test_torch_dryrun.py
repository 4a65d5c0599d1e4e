"""Port parity: the dry run (``launch/specs.py``, ``step_analysis.py``,
``dryrun.py``, ``run_dryrun_all.py`` and the dry-run table of
``launch/roofline.py``), on the CPU.

* Per-device argument bytes (rank 0's local shards) of the parameters,
  the ZeRO-1 m and v, the batch and the decode cache, for every run cell
  (10 archs x 4 shapes x 2 meshes, less the 16 skipped), equal exactly
  the reference's ``NamedSharding(AbstractMesh, spec).shard_shape`` sums
  under its own rules (no 256 devices needed there). The port's side
  runs in two subprocesses, one joining a ``"fake"`` group of 256 ranks
  and one of 512 (one group a process), started with the module and
  read by its last tests; the first also traces one whole cell and a
  hand-built DTensor matmul whose collectives are known.
* The skipped cells are the reference's 16; ``model_flops`` is the
  reference's exactly (its ``dryrun.py`` sets ``XLA_FLAGS`` to 512 host
  devices when imported, so it runs in a subprocess).
* One device, no mesh: the dry run's dot FLOPs of a smoke train step
  (B=4, S=64) against ``analyze_text`` of the reference's compiled step.
  The rank-2 products (every projection, the head) are equal exactly.
  The batched products differ by construction: the reference's blocked
  attention loops its kv tiles in a ``lax.scan`` whose backward
  recomputes each tile's two products once more (10 tile products a
  tile to the port's 8: a ratio of exactly 0.8), and XLA lowers WKV6's
  outer products k^T v (no contracted dimension) to multiplies, where
  autograd's einsum backward makes them batched products of depth one
  (the port counts 4 products a step to the reference's 3: 4/3). MoE's
  dispatch and combine einsums lower to other contractions; its total
  is held within 2%. On real CPU tensors the counter equals
  ``FlopCounterMode`` exactly.
* ``run_dryrun_all``'s cell order is the reference script's; a cell
  that outlives its timeout is recorded as an error, an ``ok`` record
  is not run again; ``fraction`` and ``table`` on synthetic records
  equal the reference's under its peak.
"""
import dataclasses
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, applicable  # noqa: E402
from repro_torch.launch import dryrun as PD  # noqa: E402
from repro_torch.launch import roofline as PR  # noqa: E402
from repro_torch.launch import run_dryrun_all as PRA  # noqa: E402
from repro_torch.launch.step_analysis import StepCounter  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT_S = 900
CELLS = [(a, s, mp) for mp in (False, True) for a in ARCH_IDS
         for s in SHAPES]
RUN = [c for c in CELLS if not applicable(get_config(c[0]), SHAPES[c[1]])]
SMOKE_B, SMOKE_S = 4, 64


def _tag(cell):
    return f"{cell[0]}__{cell[1]}__{'mp' if cell[2] else 'sp'}"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PORT_SCRIPT = """
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import dryrun as D
from repro_torch.launch.step_analysis import StepCounter, storage_bytes
from repro_torch.sharding.rules import make_rules, place

torch.set_num_threads(1)
out = {"cells": {}}
for mp in (sys.argv[2] == "mp",):
    mesh = D.production_mesh(mp)
    if not mp:
        x = place(torch.empty(256, 64, device="meta"), mesh,
                  (Replicate(), Shard(1)))
        w = place(torch.empty(64, 32, device="meta"), mesh,
                  (Replicate(), Shard(0)))
        z = place(torch.empty(256, 32, device="meta"), mesh,
                  (Shard(0), Replicate()))
        rep = (Replicate(), Replicate())
        with StepCounter() as c:
            (x @ w).redistribute(mesh, rep)                  # all-reduce
            (x @ w).redistribute(mesh, (Replicate(), Shard(0)))  # r-s
            z.redistribute(mesh, rep)                        # all-gather
        out["conventions"] = c.summary()
        out["whole_cell"] = D.build_cell("whisper-tiny", "decode_32k",
                                         False)
    for arch in ARCH_IDS:
        for s in SHAPES:
            shape = SHAPES[s]
            if applicable(get_config(arch), shape):
                continue
            cfg = D.cell_config(arch, mesh)
            rules = make_rules(cfg, mesh, batch_size=shape.global_batch)
            cell = D.place_cell(cfg, shape, mesh, rules)
            r = {"params": storage_bytes(D.leaves(cell["params"])),
                 "batch": storage_bytes(D.leaves(cell["batch"]))}
            if cell["opt"] is not None:
                for k in ("m", "v"):
                    r[k] = storage_bytes(D.leaves(cell["opt"][k]))
            if cell["cache"] is not None:
                r["cache"] = storage_bytes(D.leaves(cell["cache"]))
            out["cells"][f"{arch}__{s}__{'mp' if mp else 'sp'}"] = r
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(autouse=True, scope="module")
def port_process(tmp_path_factory):
    """The port's side in two subprocesses, one a mesh (a process joins
    one group), started with the module (its first tests run meanwhile)
    and killed at its end if still running."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for mesh in ("sp", "mp"):
        with open(tmp / f"stderr_{mesh}.txt", "w") as err:
            procs[mesh] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(PORT_SCRIPT),
                 str(tmp / f"port_{mesh}.json"), mesh],
                stdout=subprocess.DEVNULL, stderr=err, env=env)
    yield procs, tmp
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def port_side(port_process):
    """The port's per-device bytes of every run cell, the conventions
    matmul's counts and one whole cell's record."""
    procs, tmp = port_process
    out = {"cells": {}}
    for mesh, proc in procs.items():
        proc.wait(timeout=TIMEOUT_S)
        assert proc.returncode == 0, \
            (tmp / f"stderr_{mesh}.txt").read_text()[-4000:]
        part = json.loads((tmp / f"port_{mesh}.json").read_text())
        out["cells"].update(part.pop("cells"))
        out.update(part)
    return out


def _ref_mesh(mp):
    from jax.sharding import AbstractMesh
    return (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if mp
            else AbstractMesh((16, 16), ("data", "model")))


def _shard_bytes(tree, shardings):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    leaves = jax.tree.leaves(tree)
    sh = jax.tree.leaves(shardings,
                         is_leaf=lambda s: isinstance(s, NamedSharding))
    assert len(leaves) == len(sh)
    return sum(math.prod(s.shard_shape(x.shape))
               * jnp.dtype(x.dtype).itemsize for x, s in zip(leaves, sh))


@functools.lru_cache(maxsize=None)
def _ref_abstract(cfg, train: bool):
    """The reference's abstract train state (``train``) or parameters of
    ``cfg``, shared by the cells of one config."""
    from repro.launch import specs as RSP
    return (RSP.abstract_train_state(cfg) if train
            else RSP.abstract_params(cfg))


def _ref_bytes(arch, shape_name, mp):
    """The reference's per-device bytes of a cell's arguments: its shard
    shapes on an AbstractMesh under its own rules and specs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import get_config as rget
    from repro.launch import specs as RSP
    from repro.sharding.rules import (logical_to_spec, make_rules,
                                      param_shardings)
    mesh = _ref_mesh(mp)
    shape = SHAPES[shape_name]
    cfg = RSP.tune_for_mesh(rget(arch), mesh)
    rules = make_rules(cfg, mesh, batch_size=shape.global_batch,
                       profile="tp")
    out = {}
    if shape.kind == "train":
        st = _ref_abstract(cfg, True)
        sh = RSP.train_state_shardings(st, cfg, mesh, rules)
        out["params"] = _shard_bytes(st["params"], sh["params"])
        for k in ("m", "v"):
            out[k] = _shard_bytes(st["opt"][k], sh["opt"][k])
        b = RSP.input_specs(cfg, shape)
        out["batch"] = _shard_bytes(b, RSP.batch_shardings(b, mesh, rules))
        return out
    ps = _ref_abstract(cfg, False)
    out["params"] = _shard_bytes(ps, param_shardings(ps, mesh, rules))
    if shape.kind == "prefill":
        b = RSP.input_specs(cfg, shape)
        out["batch"] = _shard_bytes(b, RSP.batch_shardings(b, mesh, rules))
        return out
    inputs = RSP.input_specs(cfg, shape, abstract_params=ps)
    tokens = jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)
    out["batch"] = _shard_bytes(tokens, NamedSharding(
        mesh, logical_to_spec(("batch", None), rules)))
    out["cache"] = _shard_bytes(inputs["cache"], RSP.cache_shardings(
        inputs["cache"], mesh, rules))
    return out


@pytest.mark.parametrize("cell", CELLS, ids=_tag)
def test_cell_status_matches_reference(cell):
    """The reference's 16 skipped cells (long_500k of the eight
    full-attention archs on both meshes) are skipped with its reason;
    build_cell returns a skipped record before joining any group."""
    from repro.configs import get_config as rget
    from repro.configs.shapes import SHAPES as RSHAPES
    from repro.configs.shapes import applicable as rapplicable
    arch, shape, mp = cell
    want = rapplicable(rget(arch), RSHAPES[shape])
    assert applicable(get_config(arch), SHAPES[shape]) == want
    if want:
        rec = PD.build_cell(arch, shape, mp)
        assert rec == {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "skipped", "reason": want}


def test_sixteen_cells_are_skipped():
    assert len(CELLS) - len(RUN) == 16


def test_model_flops_equal_reference():
    """The reference's ``model_flops`` of every (arch, shape), in a
    subprocess (importing its dry run sets 512 host devices)."""
    code = textwrap.dedent("""
        import json
        from repro.configs import ARCH_IDS, get_config
        from repro.configs.shapes import SHAPES
        from repro.launch.dryrun import model_flops
        print(json.dumps({f"{a}|{s}": model_flops(get_config(a), SHAPES[s])
                          for a in ARCH_IDS for s in SHAPES}))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    got = {f"{a}|{s}": PD.model_flops(get_config(a), SHAPES[s])
           for a in ARCH_IDS for s in SHAPES}
    assert got == want


# ---------------------------------------------------------------------------
# one device: the counter against the reference's HLO and FlopCounterMode
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_dots(arch):
    """(rank-2 dot FLOPs, batched dot FLOPs) of the reference's compiled
    one-device smoke train step, through its ``hlo_analysis`` parser."""
    import re
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as rsmoke
    from repro.launch.hlo_analysis import HloProgram, _shape_dims
    from repro.optim.adamw import AdamWConfig
    from repro.train import step as RS
    rcfg = dataclasses.replace(rsmoke(arch), remat="layer")
    st = jax.eval_shape(lambda: RS.init_train_state(jax.random.PRNGKey(0),
                                                    rcfg))
    i32 = jnp.int32
    batch = {"tokens": jax.ShapeDtypeStruct((SMOKE_B, SMOKE_S), i32),
             "labels": jax.ShapeDtypeStruct((SMOKE_B, SMOKE_S), i32)}
    if rcfg.is_enc_dec:
        batch["enc_frames"] = jax.ShapeDtypeStruct(
            (SMOKE_B, SMOKE_S, rcfg.d_model), jnp.float32)
    prog = HloProgram(jax.jit(RS.make_train_step(rcfg, AdamWConfig())).lower(
        st, batch).compile().as_text())
    plain = batched = 0.0
    for op in prog.ops.values():
        if op["opcode"] != "dot":
            continue
        args = re.search(r"dot\(([^)]*)\)", op["line"]).group(1).split(",")
        lhs = _shape_dims(prog.ops[args[0].strip().lstrip("%")]["type"])
        mcd = re.search(r"lhs_contracting_dims={([0-9,]*)}", op["line"])
        k = math.prod(lhs[int(d)] for d in mcd.group(1).split(",")
                      if d) if mcd else 1
        f = 2 * math.prod(_shape_dims(op["type"])) * k \
            * prog.mult.get(op["comp"], 1.0)
        if re.search(r"lhs_batch_dims={[0-9]", op["line"]):
            batched += f
        else:
            plain += f
    return plain, batched, prog.summary()["dot_flops"]


def _port_dots(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), remat="layer")
    seq = 2 * SMOKE_S if cfg.is_enc_dec else SMOKE_S    # split_lens
    return PD.analyze_train_step(cfg, SMOKE_B, seq)["ops"]


#: port / reference of the batched products (see the module docstring)
BATCHED_RATIO = {"qwen3-0.6b": 0.8, "recurrentgemma-9b": 0.8,
                 "whisper-tiny": 0.8, "rwkv6-3b": 4 / 3}


@pytest.mark.parametrize("arch", sorted(BATCHED_RATIO))
def test_one_device_dot_flops_against_reference_hlo(arch):
    plain, batched, total = _ref_dots(arch)
    port = _port_dots(arch)
    assert port["flops_by_op"]["mm"] == plain
    assert port["flops_by_op"]["bmm"] / batched == pytest.approx(
        BATCHED_RATIO[arch], rel=1e-12)
    assert port["dot_flops"] == port["flops_by_op"]["mm"] + \
        port["flops_by_op"]["bmm"]
    assert total == plain + batched


def test_one_device_moe_dot_flops_within_two_percent_of_reference():
    _, _, total = _ref_dots("granite-moe-1b-a400m")
    got = _port_dots("granite-moe-1b-a400m")["dot_flops"]
    assert 0.98 <= got / total <= 1.0


def test_counter_equals_flop_counter_mode_on_real_tensors():
    """On real CPU tensors and one device, the counter's dot FLOPs are
    ``FlopCounterMode``'s, and its peak covers the step's live bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import step as PS
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                              attention_impl="blocked", remat="layer")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4), 0).items()}
    counts = []
    for mode in (StepCounter, lambda: FlopCounterMode(display=False)):
        state = PS.init_train_state(cfg, generator=torch.Generator(
            "cpu").manual_seed(0), device="cpu")
        step = PS.make_train_step(cfg, AdamWConfig())
        with mode() as m:
            step(state, batch)
        counts.append(m.dot_flops if isinstance(m, StepCounter)
                      else m.get_total_flops())
    assert counts[0] == counts[1] > 0


def test_live_bytes_count_only_what_the_step_creates():
    """A view of an argument or an in-place update of one creates no
    storage; a new tensor counts from its creation until it is freed.
    (Counted as created, the arguments' views and in-place results put a
    train step's parameters, m and v among its temporaries: qwen3-0.6b's
    full train step at B=4 x T=512 read 12.08 GB of temporaries, 5.50 GB
    with the arguments known.)"""
    x = torch.zeros(256, 64)
    n = x.numel() * x.element_size()
    with StepCounter([x]) as c:
        x.mul_(2)
        x.t()
        x.t().contiguous()                  # created and freed at once
        y = x + 1
    assert (c.peak, c.live) == (n, n)
    del y
    assert c.live == 0
    with StepCounter() as c:                # x unknown: its update counts
        x.mul_(2)
    assert c.peak == n


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "granite-moe-1b-a400m"))
def test_meta_trace_live_bytes_equal_a_real_cpu_steps(arch):
    """The dry run's temporaries of a smoke train step on ``meta`` are
    those the same step creates on real CPU tensors."""
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import step as PS
    cfg = dataclasses.replace(get_smoke_config(arch),
                              attention_impl="blocked", remat="layer")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4), 0).items()}
    state = PS.init_train_state(cfg, generator=torch.Generator(
        "cpu").manual_seed(0), device="cpu")
    real = PD.trace(PS.make_train_step(cfg, AdamWConfig()), state, batch)
    meta = PD.analyze_train_step(cfg, 4, 32)
    assert real["temp_bytes"] == meta["temp_bytes"] > 0


# ---------------------------------------------------------------------------
# the sweep and the table
# ---------------------------------------------------------------------------
def _ref_sweep_module():
    spec = importlib.util.spec_from_file_location(
        "ref_run_dryrun_all", os.path.join(ROOT, "scripts",
                                           "run_dryrun_all.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sweep_cell_order_is_the_reference_scripts():
    ref = _ref_sweep_module()
    assert list(PRA.cells()) == list(ref.cells())
    assert PRA.PREFLIGHT == ref.PREFLIGHT
    assert len(list(PRA.cells())) == 80


def test_sweep_records_a_timeout_and_keeps_an_ok_record(tmp_path):
    cell = ("qwen3-0.6b", "train_4k", False)
    line = PRA.run_cell(*cell, results=tmp_path, timeout=0.01)
    assert "TIMEOUT" in line
    rec = json.loads((tmp_path / f"{_tag(cell)}.json").read_text())
    assert rec["status"] == "error" and "timeout" in rec["error"]
    (tmp_path / f"{_tag(cell)}.json").write_text(json.dumps(
        {"arch": cell[0], "shape": cell[1], "status": "ok"}))
    assert "cached (ok)" in PRA.run_cell(*cell, results=tmp_path,
                                         timeout=0.01)


def _synthetic_rows():
    def ok(arch, shape, c, m, k, mf, chips=256, ratio=0.5, gb=12.25):
        return {"arch": arch, "shape": shape, "status": "ok",
                "chips": chips,
                "roofline": {"compute_s": c, "memory_s": m,
                             "collective_s": k, "model_flops_global": mf,
                             "useful_flops_ratio": ratio,
                             "dominant": max((("compute", c), ("memory", m),
                                              ("collective", k)),
                                             key=lambda kv: kv[1])[0]},
                "memory": {"peak_estimate_gb": gb}}
    return {
        "a__train_4k__sp": ok("a", "train_4k", 0.5, 0.2, 0.1, 3e16),
        "b__decode_32k__sp": ok("b", "decode_32k", 1e-4, 2e-3, 5e-3, 1e12,
                                ratio=None),
        "c__long_500k__sp": {"arch": "c", "shape": "long_500k",
                             "status": "skipped", "reason": "quadratic"},
        "d__prefill_32k__sp": {"arch": "d", "shape": "prefill_32k",
                               "status": "error", "error": "x" * 100},
        "e__train_4k__sp": ok("e", "train_4k", 0.0, 0.0, 0.0, 1e15),
        "a__train_4k__mp": ok("a", "train_4k", 0.25, 0.1, 0.3, 3e16, 512),
    }


@pytest.mark.parametrize("mesh", ("sp", "mp"))
def test_fraction_and_table_equal_reference_under_its_peak(tmp_path,
                                                           monkeypatch,
                                                           mesh):
    sys.path.insert(0, ROOT)
    from benchmarks import roofline as BR
    for name, r in _synthetic_rows().items():
        (tmp_path / f"{name}.json").write_text(json.dumps(r))
    monkeypatch.setattr(BR, "RESULTS", tmp_path)
    assert PR.table(mesh, results=tmp_path, peak=BR.PEAK_FLOPS) == \
        BR.table(mesh)
    for r in PR.load(mesh, results=tmp_path):
        assert PR.fraction(r, peak=BR.PEAK_FLOPS) == BR.fraction(r)
    # on the H100's peak the fraction scales by the peaks' ratio
    r = _synthetic_rows()["a__train_4k__sp"]
    assert PR.fraction(r) == pytest.approx(
        BR.fraction(r) * BR.PEAK_FLOPS / PR.BF16_OPS_PER_S, rel=1e-12)


# ---------------------------------------------------------------------------
# the port's side (last: its subprocess runs while the tests above run)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", RUN, ids=_tag)
def test_argument_bytes_equal_reference_shard_shapes(port_side, cell):
    """Parameters, ZeRO-1 m and v, batch and cache: one device's bytes
    equal the reference's shard shapes exactly."""
    assert port_side["cells"][_tag(cell)] == _ref_bytes(*cell)


def test_every_run_cell_was_placed(port_side):
    assert sorted(port_side["cells"]) == sorted(_tag(c) for c in RUN)
    assert len(RUN) == 64


def test_collective_conventions_on_a_known_matmul(port_side):
    """(256, 64) @ (64, 32) with the contraction over the 16-way model
    axis, twice, then a (256, 32) gathered over data: one rank multiplies
    (256, 4) @ (4, 32); the partial sum all-reduced counts 2 x its input,
    reduce-scattered 1 x its input, the gather 1 x its output."""
    c = port_side["conventions"]
    assert c["dot_flops"] == 2 * (2 * 256 * 4 * 32)
    assert c["collective_bytes"] == {"all-reduce": 2 * 256 * 32 * 4,
                                     "reduce-scatter": 256 * 32 * 4,
                                     "all-gather": 256 * 32 * 4}
    assert c["collective_calls"] == {"all-reduce": 1, "reduce-scatter": 1,
                                     "all-gather": 1}


def test_whole_cell_record(port_side):
    """One traced cell (whisper-tiny decode_32k on 16 x 16): the
    reference's schema with ``trace_s`` and ``ops``; its argument bytes
    are its parameters', tokens' and cache's; its roofline terms are its
    counts over the constants."""
    rec = port_side["whole_cell"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert {"lower_s", "trace_s", "memory", "ops", "roofline",
            "variant", "kv_repeat"} <= set(rec)
    parts = port_side["cells"]["whisper-tiny__decode_32k__sp"]
    mem = rec["memory"]
    assert mem["argument_bytes_per_device"] == sum(parts.values())
    # the cross-attention keys and values pass through decode_step as
    # they are: their storages are the output's too
    assert 0 < mem["alias_bytes_per_device"] < parts["cache"]
    assert mem["peak_estimate_gb"] == round(
        (mem["argument_bytes_per_device"]
         + mem["temp_bytes_per_device"]) / 2**30, 3)
    ops, roof = rec["ops"], rec["roofline"]
    assert ops["dot_flops_per_device"] > 0
    assert ops["collective_total_per_device"] == sum(
        ops["collective_bytes_per_device"].values())
    assert roof["compute_s"] == ops["dot_flops_per_device"] / PD.PEAK_FLOPS
    assert roof["collective_s"] == (ops["collective_total_per_device"]
                                    / PD.LINK_BW)
    assert roof["model_flops_global"] == PD.model_flops(
        get_config("whisper-tiny"), SHAPES["decode_32k"])
