"""Full-parameter training: the port's stage tables, merged params and optimizer
against the JAX package's, at the TINY configs.

The six stage tables (`vla_scripts/train.py` and `pretrain.py`'s
STAGE_TRAINABLE, and the port's `scripts/train.py`, `scripts/pretrain.py`)
split the same numpy weights (the JAX init with the lm_head) on both sides;
the batch is `test_training._batch` under the discrete objective, the JAX
side runs its `train_step` eagerly and the port its own.

Tolerances, fp32 (the stage tables): the merged params equal the JAX ones
bit for bit; loss within 1e-5 and grad norm within 1e-4 relative; every
gradient leaf within 1e-3 of its largest entry with a cosine >= 0.99999;
after each AdamW update the trainables agree to 1e-5 wherever the sign of
the first update is determined (the JAX gradient above 1% of its leaf's
largest entry), and elsewhere within 2 lr a step (Adam's first update is
about lr sign(g), so fp32 noise at g near 0 may flip it). Frozen leaves stay
bitwise unchanged on the port's side.

bf16 (`Bf16AdamW`, optax's AdamW on bf16 leaves with bf16 moments): bitwise
against optax op by op (`jax.disable_jit`, where every op rounds to bf16),
over 5 updates with weight decay and a stacked leaf. Under `jit` XLA's CPU
compiler keeps some intermediates in fp32 (excess precision), so there the
parameters and moments agree to one bf16 ulp (2^-7 relative). One bf16
`vla-full-train` step end to end: loss within 1e-2 relative (bf16
products in two frameworks), the first moments' cosine >= 0.99 and the
updates' cosine >= 0.9 per group.
"""

import io
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from openvla_oft_tpu.constants import LIBERO
from openvla_oft_tpu.policy import init_openvla_params
from openvla_oft_tpu.training import train_step as JT
from openvla_oft_tpu_torch.bridge import index_layer, params_from_numpy, tree_leaves
from openvla_oft_tpu_torch.scripts import pretrain as PP
from openvla_oft_tpu_torch.scripts import train as PTR
from openvla_oft_tpu_torch.training import train_step as TT
from test_torch_import import port_config, port_platform
from test_training import CFG, _batch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from vla_scripts import pretrain as JPRE  # noqa: E402
from vla_scripts import train as JTRAIN  # noqa: E402

P_CFG, P_LIBERO = port_config(CFG), port_platform(LIBERO)
LR = 1e-3
STAGES = {**{s: (keys, 0.0) for s, keys in JTRAIN.STAGE_TRAINABLE.items()},
          **{s: (keys, 0.01) for s, keys in JPRE.STAGE_TRAINABLE.items()}}


def test_stage_tables_match_jax():
    assert PTR.STAGE_TRAINABLE == JTRAIN.STAGE_TRAINABLE
    assert PP.STAGE_TRAINABLE == JPRE.STAGE_TRAINABLE
    assert len(STAGES) == 6


def _np_full(dtype=jnp.float32):
    full = init_openvla_params(jax.random.PRNGKey(0), CFG, LIBERO, dtype=dtype, head=None,
                               with_lm_head=True)
    return jax.tree_util.tree_map(np.asarray, full)


NP_FULL = _np_full()
NP_BATCH = {k: np.asarray(v) for k, v in _batch().items()}


def _jax_split(full, keys):
    """The JAX scripts' split of a stage."""
    base = {k: v for k, v in full.items() if k not in keys}
    tr = {k: full[k] for k in keys if k in full}
    if "llm_last_layer" in keys:
        tr["llm_last_layer"] = {
            "layers": jax.tree_util.tree_map(lambda a: a[-1], full["llm"]["layers"]),
            "embed": full["llm"]["embed"], "lm_head": full["llm"]["lm_head"]}
    return base, tr


def _paths(tree, prefix=""):
    """{path: leaf} of a nested dict tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(t):
    """A numpy copy (fp32 for bf16 leaves)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().copy()
    return np.asarray(t, np.float32) if np.asarray(t).dtype.name == "bfloat16" \
        else np.asarray(t)


def _materialized(tree):
    """A merged tree with every LastSliceOverride stacked back into a tensor."""
    if isinstance(tree, dict):
        return {k: _materialized(v) for k, v in tree.items()}
    if isinstance(tree, TT.LastSliceOverride):
        return torch.stack([tree[i] for i in range(tree.shape[0])])
    return tree


def _port_cfg(wd):
    return TT.TrainConfig(objective="discrete", learning_rate=LR, weight_decay=wd,
                          use_proprio=False, num_steps_before_decay=10 ** 9)


def _jax_cfg(wd):
    return JT.TrainConfig(objective="discrete", learning_rate=LR, weight_decay=wd,
                          use_proprio=False, num_steps_before_decay=10 ** 9,
                          remat_policy="none")


@pytest.mark.parametrize("stage", list(STAGES))
def test_merged_params_match_jax(stage):
    keys, wd = STAGES[stage]
    jb, jt = _jax_split(jax.tree_util.tree_map(jnp.asarray, NP_FULL), keys)
    want = _paths(jax.tree_util.tree_map(np.asarray, JT._merged_params(jb, jt, _jax_cfg(wd))))
    base, tr = PTR.split_stage(params_from_numpy(NP_FULL), keys)
    got = _paths(_materialized(TT._merged_params(base, tr, _port_cfg(wd))))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(_np(got[path]), w, err_msg=path)
    if "llm_last_layer" in keys:
        layers = TT._merged_params(base, tr, _port_cfg(wd))["llm"]["layers"]
        n = NP_FULL["llm"]["layers"]["attn"]["wq"]["kernel"].shape[0]
        last = index_layer(layers, n - 1)
        # slice L-1 is the trainable tensor itself, the others the base's views
        assert last["attn"]["wq"]["kernel"] is tr["llm_last_layer"]["layers"]["attn"]["wq"]["kernel"]
        assert index_layer(layers, 0)["attn"]["wq"]["kernel"].data_ptr() == \
            base["llm"]["layers"]["attn"]["wq"]["kernel"].data_ptr()


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float((a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _jax_grads(state, cfg):
    """The JAX step's loss and gradients on the batch (eager)."""
    (loss, _), grads = jax.value_and_grad(JT.loss_and_metrics, has_aux=True)(
        state.trainables, state.base_params, {k: jnp.asarray(v) for k, v in NP_BATCH.items()},
        CFG, LIBERO, cfg, jax.random.PRNGKey(0), False)
    return float(loss), grads


@pytest.mark.parametrize("stage", list(STAGES))
def test_two_train_steps_match_jax(stage):
    keys, wd = STAGES[stage]
    jcfg, pcfg = _jax_cfg(wd), _port_cfg(wd)
    jb, jt = _jax_split(jax.tree_util.tree_map(jnp.asarray, NP_FULL), keys)
    jstate = JT.create_train_state(jb, jt, jcfg, jax.random.PRNGKey(0))
    tx = JT.make_optimizer(jcfg)
    base, tr = PTR.split_stage(params_from_numpy(NP_FULL), keys)
    frozen = {p: t.clone() for p, t in _paths(base).items()}
    pstate = TT.create_train_state(base, tr, pcfg)
    batch = {k: torch.from_numpy(v.copy()) for k, v in NP_BATCH.items()}
    sure = None
    for step in range(2):
        before = {p: _np(t) for p, t in _paths(pstate.trainables).items()}
        loss_j, grads_j = _jax_grads(jstate, jcfg)
        jstate, jm = JT.train_step(jstate, {k: jnp.asarray(v) for k, v in NP_BATCH.items()},
                                   CFG, LIBERO, jcfg, tx=tx)
        leaves = tree_leaves(pstate.trainables)
        loss_t, _ = TT.loss_and_metrics(pstate.trainables, pstate.base_params, batch, P_CFG,
                                        P_LIBERO, pcfg)
        grads_t = dict(zip(_paths(pstate.trainables), torch.autograd.grad(loss_t, leaves)))
        pstate, pm = TT.train_step(pstate, batch, P_CFG, P_LIBERO, pcfg)
        np.testing.assert_allclose(float(pm["loss"]), loss_j, rtol=1e-5)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        gj = {p: np.asarray(g) for p, g in _paths(grads_j).items()}
        assert sorted(gj) == sorted(grads_t)
        new_j = {p: np.asarray(v) for p, v in _paths(jstate.trainables).items()}
        new_t = {p: _np(t) for p, t in _paths(pstate.trainables).items()}
        if sure is None:
            sure = {p: np.abs(g) > 1e-2 * np.abs(g).max() for p, g in gj.items()}
        for path, g in gj.items():
            got = _np(grads_t[path])
            scale = np.abs(g).max()
            if scale == 0:       # e.g. an embedding row no token reads
                assert not got.any(), path
                continue
            assert np.abs(got - g).max() <= 1e-3 * scale, path
            assert _cos(got, g) >= 0.99999, path
            diff = np.abs(new_t[path] - new_j[path])
            assert diff[sure[path]].max(initial=0) <= 1e-5, path
            assert diff.max() <= 2 * LR * (step + 1) + 1e-6, path
            assert (new_t[path] != before[path]).any(), f"{path} did not move"
    for path, t in _paths(pstate.base_params).items():
        assert torch.equal(t, frozen[path]), f"frozen {path} changed"


def test_last_layer_stage_moves_only_the_last_slice_embed_and_lm_head(tmp_path):
    """Mirror of tests/test_training.py::test_train_last_layer_stage_freezes_early_layers
    through the port's script: a 2-step run, the checkpoint holds only
    `llm_last_layer`, whose slices moved from the init's slice L-1, while
    the merged tree's slices 0..L-2 stay the init's."""
    from openvla_oft_tpu_torch.training.checkpoint import restore_checkpoint

    out = PTR.train(PTR.TrainConfig(
        vla_id="tiny", stage="vla-last-layer-train", pretrained_checkpoint="random:tiny",
        data_root_dir=Path("dummy"), dataset_name="libero_dummy", batch_size=2, max_steps=2,
        save_interval=2, run_root_dir=tmp_path, learning_rate=1e-2, device="cpu"))
    assert out["final_step"] == 2
    restored = restore_checkpoint(str(Path(out["run_dir"]) / "ckpt"), 2)
    assert set(restored["trainables"]) == {"llm_last_layer"}
    model_cfg = PTR.model_config("random:tiny")
    init, _ = PTR.build_full_model("random:tiny", model_cfg, P_LIBERO, torch.device("cpu"), 7)
    state = out["state"]
    merged = TT._merged_params(state.base_params, state.trainables, _port_cfg(0.0))["llm"]
    n = model_cfg.llm.num_layers
    for path, stack in _paths(init["llm"]["layers"]).items():
        node_m, node_r = merged["layers"], restored["trainables"]["llm_last_layer"]["layers"]
        for k in path.strip("/").split("/"):
            node_m, node_r = node_m[k], node_r[k]
        for i in range(n - 1):
            assert torch.equal(node_m[i], stack[i]), (path, i)
        assert torch.equal(node_r, node_m[n - 1]), path
        if path.endswith("kernel"):
            assert not torch.equal(node_r, stack[-1]), f"{path}: the last slice did not train"
    for k in ("embed", "lm_head"):
        got = restored["trainables"]["llm_last_layer"][k]
        assert not torch.equal(tree_leaves(got)[0], tree_leaves(init["llm"][k])[0]), k
    # the base's LLM (every slice, embed and lm_head) is the init's, bit for bit
    for path, t in _paths(state.base_params["llm"]).items():
        assert torch.equal(t, _paths(init["llm"])[path]), path


# === bf16: Bf16AdamW against optax ===

def _bf16_leaves(rng):
    shapes = [(5, 3), (7,), (3, 4, 6)]          # the last one stacked: updated by slices
    return [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("jit", [False, True], ids=["op_by_op", "jit"])
def test_bf16_adamw_matches_optax(wd, jit):
    rng = np.random.default_rng(4)
    params = _bf16_leaves(rng)
    grads = [[(rng.standard_normal(p.shape) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
              for p in params] for _ in range(5)]
    jcfg = JT.TrainConfig(learning_rate=3e-2, weight_decay=wd, num_steps_before_decay=3)
    tx = JT.make_optimizer(jcfg)
    pj = [jnp.asarray(p, jnp.bfloat16) for p in params]
    opt = tx.init(pj)
    pt = [torch.from_numpy(p).to(torch.bfloat16) for p in params]
    port = TT.Optimizer(TT.TrainConfig(learning_rate=3e-2, weight_decay=wd,
                                       num_steps_before_decay=3), pt)
    assert port.adamw is None and port.low is not None

    def update(g, opt, pj):
        upd, opt = tx.update(g, opt, pj)
        return optax.apply_updates(pj, upd), opt

    step = jax.jit(update) if jit else update
    for g in grads:
        gj = [jnp.asarray(x, jnp.bfloat16) for x in g]
        if jit:
            pj, opt = step(gj, opt, pj)
        else:
            with jax.disable_jit():
                pj, opt = step(gj, opt, pj)
        port.update([torch.from_numpy(x).to(torch.bfloat16) for x in g])
        adam = opt[0][0]
        for got, want in [*zip(pt, pj), *zip(port.low.mu, adam.mu), *zip(port.low.nu, adam.nu)]:
            got, want = got.float().numpy(), np.asarray(want, np.float32)
            if jit:
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-30)
            else:
                np.testing.assert_array_equal(got, want)
        assert port.low.count == int(adam.count)


def test_mixed_dtype_optimizer_state_round_trip():
    """fp32 leaves through torch AdamW, bf16 through Bf16AdamW; the state
    dict restores both bitwise (the moments of `--resume` and the save)."""
    rng = np.random.default_rng(5)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
              for s, dt in (((4, 3), torch.float32), ((2, 3, 5), torch.bfloat16),
                            ((6,), torch.bfloat16))]
    grads = [[torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)).to(p.dtype)
              for p in params] for _ in range(4)]
    cfg = TT.TrainConfig(learning_rate=1e-2, weight_decay=0.01)
    a = TT.Optimizer(cfg, params)
    assert a.fp32 == [0] and a.bf16 == [1, 2]
    for g in grads[:2]:
        a.update(g)
    buf = io.BytesIO()                    # as the checkpoint saves and restores it
    torch.save(a.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    copies = [p.clone() for p in params]
    b = TT.Optimizer(cfg, copies)
    b.load_state_dict(saved)
    for g in grads[2:]:
        a.update(g)
        b.update(g)
    for x, y in zip(params, copies):
        assert torch.equal(x, y)
    with pytest.raises(TypeError, match="fp32 and bf16"):
        TT.Optimizer(cfg, [torch.zeros(2, dtype=torch.float16)])


def test_bf16_full_train_step_against_jax():
    """One `vla-full-train` step with the bf16 tree on both sides (the
    scripts' dtypes: bf16, the projector fp32)."""
    np_full = _np_full(jnp.bfloat16)
    keys = JTRAIN.STAGE_TRAINABLE["vla-full-train"]
    jcfg, pcfg = _jax_cfg(0.0), _port_cfg(0.0)
    jb, jt = _jax_split(jax.tree_util.tree_map(jnp.asarray, np_full), keys)
    jstate = JT.create_train_state(jb, jt, jcfg, jax.random.PRNGKey(0))
    jstate, jm = jax.jit(lambda s, b: JT.train_step(s, b, CFG, LIBERO, jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in NP_BATCH.items()})
    base, tr = PTR.split_stage(params_from_numpy(np_full), keys)
    before = {p: _np(t) for p, t in _paths(tr).items()}
    assert {t.dtype for t in tree_leaves(tr["llm"])} == {torch.bfloat16}
    pstate = TT.create_train_state(base, tr, pcfg)
    pstate, pm = TT.train_step(pstate, {k: torch.from_numpy(v.copy()) for k, v in NP_BATCH.items()},
                               P_CFG, P_LIBERO, pcfg)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-2)
    new_j = {p: np.asarray(v, np.float32) for p, v in _paths(jstate.trainables).items()}
    new_t = {p: _np(t) for p, t in _paths(pstate.trainables).items()}
    mu_j = {p: np.asarray(v, np.float32)
            for p, v in _paths(jstate.opt_state[0][0].mu).items()}
    opt = pstate.optimizer
    mu_t = {}
    for i, path in zip(range(len(opt.params)), _paths(pstate.trainables)):
        mu_t[path] = (opt.low.mu[opt.bf16.index(i)].float().numpy() if i in opt.bf16
                      else opt.adamw.state[opt.params[i]]["exp_avg"].numpy())
    for group in keys:
        paths = [p for p in new_j if p.startswith(f"/{group}/")]
        cat = lambda d: np.concatenate([d[p].ravel() for p in paths])      # noqa: E731
        assert _cos(cat(mu_t), cat(mu_j)) >= 0.99, group
        upd_t = np.concatenate([(new_t[p] - before[p]).ravel() for p in paths])
        upd_j = np.concatenate([(new_j[p] - before[p]).ravel() for p in paths])
        assert _cos(upd_t, upd_j) >= 0.9, group
