"""Port: the LDM train steps against the JAX package's, on the CPU.

Both packages start from the same parameters (the JAX init, loaded into the
port) and the same batch (the JAX package's batched assembly of synthetic
solids); the port takes the draws the JAX step made (t, noise, the
condition-augmentation t and noise, the CFG label draws), replayed from the
step's key. Dropout is 0 in both (its masks cannot be shared). Bars, f32:
loss within 1e-5; gradients within 1e-4 (after the global-norm clip, read
back from both optimizers' first moments, (1 - b1) g); parameters after one step of
the LDM optimizer (global-norm clip, AdamW) within 1e-4 wherever JAX's
gradient exceeds 1e-6 in magnitude (100 x Adam's eps). Below that lie the
directions whose exact gradient is zero, such as the attention's key bias
(a constant added to every key's logit leaves the softmax unchanged): both
packages compute rounding noise there, and Adam's first step, about
lr * g / (|g| + eps), moves such an element by up to lr in either package's
direction, so those elements are held to 2 * lr. The edge stages run the
port's kernel route, whose CPU backward is K5's plain version.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from brepgen_tpu.data import batch_assembly as jBA
from brepgen_tpu.data.assembly import filter_sample
from brepgen_tpu.data.synthetic import make_dataset
from brepgen_tpu.diffusion import make_ddpm_tables as j_tables
from brepgen_tpu.nn import EdgeVAE as JEdgeVAE
from brepgen_tpu.nn import SurfVAE as JSurfVAE
from brepgen_tpu.nn import denoiser as jden
from brepgen_tpu.train import common as jcommon
from brepgen_tpu.train import ldm_train as jlt
from brepgen_tpu.train.vae_train import make_encoder_fn as j_encoder
from brepgen_tpu.train.vae_train import vae_loss as j_vae_loss
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE
from brepgen_tpu_torch.nn import denoiser as tden
from brepgen_tpu_torch.nn.transformer import TransformerEncoder, dropout
from brepgen_tpu_torch.train import ldm_train
from brepgen_tpu_torch.train.common import ClippedAdamW, TrainState, make_ldm_optimizer
from brepgen_tpu_torch.train.vae_train import make_encoder_fn, vae_loss
from brepgen_tpu_torch.weights import flatten_params, load_flax_params, to_flax_params

SMALL = dict(width=32, num_heads=2, ffn_width=64, num_layers=1, dropout=0.0)
MAX_FACE, MAX_EDGE = 10, 8
KEYS = {
    "surfpos": ("surfpos",),
    "surfz": ("surfpos", "surfpnt", "surf_mask"),
    "edgepos": ("edgepos", "surfpnt", "surfpos", "surf_mask"),
    "edgez": ("edgepnt", "edgepos", "edge_mask", "surfpnt", "surfpos", "vertpos"),
}
ASSEMBLE = {"surfpos": jBA.assemble_surfpos_batched, "surfz": jBA.assemble_surfz_batched,
            "edgepos": jBA.assemble_edgepos_batched, "edgez": jBA.assemble_edgez_batched}
FACTORIES = {"surfpos": "make_surfpos_net", "surfz": "make_surfz_net",
             "edgepos": "make_edgepos_net", "edgez": "make_edgez_net"}
STREAMS = {"surfpos": ((6,),), "surfz": ((48,), (6,)), "edgepos": ((6,), (6,), (48,)),
           "edgez": ((12,), (6,), (6,), (6,), (48,))}


def _batch(stage, seed=0, with_labels=False):
    ds = [d for d in make_dataset(8, seed=seed)
          if filter_sample(d, MAX_FACE, MAX_EDGE, 3.0, 0.05)][:3]
    kw = dict(max_face=MAX_FACE, bbox_scaled=3.0, aug=False)
    if stage.startswith("edge"):
        kw["max_edge"] = MAX_EDGE
    raw = ASSEMBLE[stage](ds, [seed + 1, seed + 2, seed + 3], **kw)
    batch = dict(zip(KEYS[stage], raw))
    if with_labels:
        batch["class_label"] = np.array([[2], [0], [5]], np.int32)
    return batch


def _vaes():
    # seeded in the port and handed to JAX as its parameter tree
    gen = torch.Generator().manual_seed(3)
    ts = seed_weights(SurfVAE((8, 8, 8, 8)), gen).eval()
    te = seed_weights(EdgeVAE((8, 8, 8)), gen).eval()
    js, je = JSurfVAE(block_out_channels=(8, 8, 8, 8)), JEdgeVAE(block_out_channels=(8, 8, 8))
    return ((j_encoder(js), to_flax_params(ts), j_encoder(je), to_flax_params(te)),
            (make_encoder_fn(ts), make_encoder_fn(te)))


def _models(stage, use_cf):
    jmodel = getattr(jden, FACTORIES[stage])(use_cf=use_cf, **SMALL)
    B, S = 2, MAX_FACE * (MAX_EDGE if stage.startswith("edge") else 1)
    streams = tuple(jnp.zeros((B, S) + d) for d in STREAMS[stage])
    label = jnp.zeros((B, 1), jnp.int32) if use_cf else None
    params = jmodel.init(jax.random.PRNGKey(1), streams, jnp.zeros((B,), jnp.int32), None, label)
    impl = "kernel" if stage.startswith("edge") else "plain"
    tmodel = getattr(tden, FACTORIES[stage])(use_cf=use_cf, attn_impl=impl, **SMALL)
    return jmodel, params, load_flax_params(tmodel, params)


def _jax_step(stage, model, opt, tables, vae, use_cf):
    se, sp, ee, ep = vae
    if stage == "surfpos":
        return jlt.make_surfpos_step(model, opt, tables, use_cf)
    if stage == "surfz":
        return jlt.make_surfz_step(model, opt, tables, se, sp, use_cf)
    if stage == "edgepos":
        return jlt.make_edgepos_step(model, opt, tables, se, sp, use_cf)
    return jlt.make_edgez_step(model, opt, tables, se, sp, ee, ep, use_cf)


def _jax_draws(stage, model, params, rng, batch, vae, use_cf):
    """The draws JAX's step makes from ``rng``, replayed in its order."""
    r = jlt._train_rngs(rng, use_cf)
    B = batch[KEYS[stage][0]].shape[0]
    surfz, pos = (B, MAX_FACE, 48), (B, MAX_FACE, 6)
    edge = (B, MAX_FACE, MAX_EDGE)
    target, conds = {"surfpos": (pos, []), "surfz": (surfz, [pos]),
                     "edgepos": (edge + (6,), [pos, surfz]),
                     "edgez": (edge + (18,), [edge + (6,), pos, surfz])}[stage]
    keys = ([r["aug"]] if len(conds) == 1 else
            list(jax.random.split(r["aug"], len(conds))) if conds else [])

    def aug(k, shape):
        k_t, k_n = jax.random.split(k)
        return (jax.random.randint(k_t, (B,), 0, jlt.AUG_MAX_T),
                jax.random.normal(k_n, shape, jnp.float32))

    draws = {"t": jax.random.randint(r["t"], (B,), 0, 1000),
             "noise": jax.random.normal(r["noise"], target, jnp.float32),
             "aug": [aug(k, s) for k, s in zip(keys, conds)]}
    if use_cf:
        key = model.apply(params, method=lambda m: m.make_rng("cfg"), rngs={"cfg": r["cfg"]})
        draws["cfg_u"] = jax.random.uniform(key, (B,))
    to_t = lambda a: torch.from_numpy(np.array(a)).long() if np.asarray(a).dtype.kind == "i" \
        else torch.from_numpy(np.array(a))  # noqa: E731
    return {"t": to_t(draws["t"]), "noise": to_t(draws["noise"]),
            "aug": [(to_t(t), to_t(n)) for t, n in draws["aug"]],
            **({"cfg_u": to_t(draws["cfg_u"])} if use_cf else {})}


def _flat_jax(params):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}


def _torch_grads_flax(module, grads):
    """Port gradients under the flax paths (layouts turned as the weights)."""
    holder = copy.deepcopy(module)
    holder.load_state_dict({k: grads[k].detach() for k in holder.state_dict()})
    return flatten_params(to_flax_params(holder))


CASES = [("surfpos", False), ("surfz", False), ("edgepos", False), ("edgez", False),
         ("surfpos", True)]


@pytest.fixture(scope="module")
def vaes():
    return _vaes()


@pytest.mark.parametrize("stage,use_cf", CASES, ids=[f"{s}{'-cfg' if c else ''}" for s, c in CASES])
def test_step_matches_jax(stage, use_cf, vaes):
    jvae, (surf_encode, edge_encode) = vaes
    batch = _batch(stage, seed=4, with_labels=use_cf)
    jmodel, params, tmodel = _models(stage, use_cf)
    for seed in range(7, 100):  # a key whose label draws drop some labels and keep others
        rng = jax.random.PRNGKey(seed)
        draws = _jax_draws(stage, jmodel, params, rng, batch, jvae, use_cf)
        if not use_cf or ((draws["cfg_u"] <= 0.1).any() and (draws["cfg_u"] > 0.1).any()):
            break
    opt = jcommon.make_ldm_optimizer()
    jstate, jm = _jax_step(stage, jmodel, opt, j_tables(), jvae, use_cf)(
        jcommon.init_state(params, opt), {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    state = TrainState(tmodel, make_ldm_optimizer(tmodel.parameters()))
    step = ldm_train.make_step(stage, tmodel, make_ddpm_tables(), surf_encode, edge_encode,
                               use_cf)
    tm = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, None,
              draws)
    assert state.step == 1 and int(jstate.step) == 1
    for k in ("loss", "loss_z", "loss_v"):
        if k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5, k

    # the clipped gradients, from the first moments (1 - b1) g of both optimizers
    b1 = 0.95
    jgrads = {k: v / (1 - b1) for k, v in _flat_jax(jstate.opt_state[1][0].mu).items()}
    moments = {n: state.optimizer.adamw.state[p]["exp_avg"] / (1 - b1)
               for n, p in tmodel.named_parameters()}
    tgrads = _torch_grads_flax(tmodel, moments)
    assert set(tgrads) == set(jgrads)
    for k, g in jgrads.items():
        assert np.abs(tgrads[k] - g).max() <= 1e-4, k

    got = flatten_params(to_flax_params(tmodel))
    lr = 5e-4
    for k, v in _flat_jax(jstate.params).items():
        diff = np.abs(got[k] - v)
        live = np.abs(jgrads[k]) > 1e-6
        assert diff[live].max(initial=0.0) <= 1e-4, k
        assert diff.max() <= 2 * lr, k


@pytest.mark.parametrize("stage", ["surfz", "edgez"])
def test_val_step_matches_jax(stage, vaes):
    jvae, (surf_encode, edge_encode) = vaes
    batch = _batch(stage, seed=6)
    jmodel, params, tmodel = _models(stage, False)
    se, sp, ee, ep = jvae
    jval = jlt.make_val_step(stage, jmodel, j_tables(), se, sp, ee, ep)
    val = ldm_train.make_val_step(stage, tmodel, make_ddpm_tables(), surf_encode, edge_encode)
    B = 3
    shape = (B, MAX_FACE, 48) if stage == "surfz" else (B, MAX_FACE, MAX_EDGE, 18)
    for t_fixed in (10, 500):
        rng = jax.random.PRNGKey(t_fixed)
        js, jc = jval(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng, t_fixed)
        noise = torch.from_numpy(np.array(jax.random.normal(rng, shape, jnp.float32)))
        ts, tc = val({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, t_fixed,
                     noise=noise)
        assert float(tc) == float(jc) == B
        assert abs(float(ts) - float(js)) <= 1e-4 * max(1.0, abs(float(js)))


def test_clip_above_the_limit_matches_optax():
    # three steps with gradients whose global norm is far above the clip
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 40).astype(np.float32) for s in shapes] for _ in range(3)]
    opt = optax.chain(optax.clip_by_global_norm(50.0),
                      optax.adamw(5e-4, b1=0.95, b2=0.999, eps=1e-8, weight_decay=1e-6))
    jp = [jnp.asarray(p) for p in params]
    st = opt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = make_ldm_optimizer(tp)
    for g in grads:
        assert np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g)) > 50.0
        updates, st = opt.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        norm = topt.step()
        assert abs(float(norm) - float(optax.global_norm([jnp.asarray(x) for x in g]))) <= 1e-3
        for p, want in zip(tp, jp):
            assert np.abs(p.detach().numpy() - np.asarray(want)).max() <= 1e-6
    assert all(p.grad is None for p in tp)


def test_clip_below_the_limit_leaves_gradients():
    p = torch.nn.Parameter(torch.zeros(4))
    opt = ClippedAdamW([p], lr=0.0, clip=50.0)
    p.grad = torch.full((4,), 2.0)
    assert float(opt.step()) == 4.0  # norm 4 < 50: unclipped, lr 0 leaves p
    assert torch.equal(p.detach(), torch.zeros(4))


def test_dropout_rate_and_seed():
    x = torch.ones((200, 500))
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, gen)
    kept = (y != 0).float().mean().item()
    # 1e5 Bernoulli(0.9) draws: sigma ~ 9.5e-4
    assert abs(kept - 0.9) < 5e-3
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))
    again = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    assert not torch.equal(y, dropout(x, 0.1, torch.Generator().manual_seed(1)))


@pytest.mark.parametrize("remat", [False, True])
def test_train_mode_reproducible_and_remat_equal(remat):
    # the same seed gives the same outputs and gradients; the recompute of a
    # checkpointed layer draws the same dropout masks as the first pass
    torch.manual_seed(0)
    enc = TransformerEncoder(32, 2, 64, 2, remat=False)
    x = torch.randn((2, 9, 32))
    mask = torch.zeros((2, 9), dtype=torch.bool)
    mask[1, 5:] = True

    def run(module, seed):
        module.zero_grad()
        out = module(x, mask, train=True, generator=torch.Generator().manual_seed(seed))
        out.sum().backward()
        return out.detach(), [p.grad.clone() for p in module.parameters()]

    out0, g0 = run(enc, 3)
    other = TransformerEncoder(32, 2, 64, 2, remat=remat)
    other.load_state_dict(enc.state_dict())
    out1, g1 = run(other, 3)
    assert torch.equal(out0, out1)
    for a, b in zip(g0, g1):
        assert torch.allclose(a, b, atol=1e-6)
    out2, _ = run(enc, 4)
    assert not torch.equal(out0, out2)
    with torch.no_grad():
        assert torch.equal(enc(x, mask), enc(x, mask, train=False))


def test_remat_dots_and_missing_generator_raise():
    with pytest.raises(ValueError, match="dots"):
        TransformerEncoder(32, 2, 64, 1, remat="dots")
    with pytest.raises(ValueError, match="generator"):
        TransformerEncoder(32, 2, 64, 1)(torch.zeros((1, 3, 32)), train=True)


def test_label_dropout_to_class_zero():
    net = tden.make_surfpos_net(use_cf=True, width=32, num_heads=2, ffn_width=64,
                                num_layers=1, dropout=0.0)
    x = torch.randn((3, 4, 6))
    t = torch.tensor([5, 5, 5])
    label = torch.tensor([[2], [3], [4]])
    u = torch.tensor([0.05, 0.5, 0.1])  # <= 0.1 drops to 0
    with torch.no_grad():
        got = net((x,), t, None, label, train=True, label_u=u)
        want = net((x,), t, None, torch.tensor([[0], [3], [0]]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("option", ["surface", "edge"])
def test_vae_loss_matches_jax(option):
    # the sampled posterior takes the draw JAX made from the same key
    gen = torch.Generator().manual_seed(4)
    if option == "surface":
        tvae, jvae = seed_weights(SurfVAE((8, 8, 8, 8)), gen), JSurfVAE(block_out_channels=(8, 8, 8, 8))
        x, latent = np.random.default_rng(0).normal(size=(3, 32, 32, 3)), (3, 4, 4, 3)
    else:
        tvae, jvae = seed_weights(EdgeVAE((8, 8, 8)), gen), JEdgeVAE(block_out_channels=(8, 8, 8))
        x, latent = np.random.default_rng(0).normal(size=(3, 32, 3)), (3, 4, 3)
    x = x.astype(np.float32)
    rng = jax.random.PRNGKey(5)
    jloss, (jmse, jkl) = j_vae_loss(jvae, to_flax_params(tvae), jnp.asarray(x), rng)
    eps = torch.from_numpy(np.array(jax.random.normal(rng, latent, jnp.float32)))
    loss, (mse, kl) = vae_loss(tvae, torch.from_numpy(x), eps=eps)
    assert abs(float(mse) - float(jmse)) <= 1e-5 * max(1.0, float(jmse))
    assert abs(float(kl) - float(jkl)) <= 1e-4 * max(1.0, float(jkl))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0, float(jloss))


def test_bf16_step_keeps_f32_state_and_near_f32_loss():
    # --bf16: autocast compute over f32 parameters and optimizer state; the
    # loss within 5e-3 relative of the f32 step's (about one bf16 rounding,
    # 2^-8; measured at most 5.3e-4 at this width)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch("edgepos", seed=2).items()}
    gen = torch.Generator().manual_seed(0)
    encode = make_encoder_fn(seed_weights(SurfVAE((8, 8, 8, 8)), gen))
    losses = {}
    for dtype in (None, torch.bfloat16):
        net = seed_weights(tden.make_edgepos_net(width=64, num_heads=2, ffn_width=128,
                                                 num_layers=2, attn_impl="kernel"),
                           torch.Generator().manual_seed(1))
        state = TrainState(net, make_ldm_optimizer(net.parameters()))
        step = ldm_train.make_edgepos_step(net, make_ddpm_tables(), encode, compute_dtype=dtype)
        losses[dtype] = float(step(state, batch, torch.Generator().manual_seed(2))["loss"])
        assert all(p.dtype == torch.float32 for p in net.parameters())
        assert all(v.dtype == torch.float32 for s in state.optimizer.adamw.state.values()
                   for k, v in s.items() if k != "step")
    assert abs(losses[torch.bfloat16] - losses[None]) <= 5e-3 * losses[None]
