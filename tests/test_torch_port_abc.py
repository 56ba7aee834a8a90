"""Port: the sample CLI's config (``--config``, the presets, the class label),
the class-conditional packs, and face-token compaction, against the JAX
package.

- The config reader gives what ``yaml.safe_load`` gives; ``--mode furniture``
  carries the chair label (6) and its CFG halves differ.
- The cf160k packs load with their class count (4) and each denoiser, run
  with class labels, agrees with JAX's at 1e-4 (CPU, f32); held160k loads.
- The compacted cascade equals the uncompacted one on the kept faces (PNDM
  stages: masked keys add exp(-1e9) = 0, so only summation order differs;
  1e-4), with one, equal and ragged kept counts, and a tiny compacted cascade
  equals JAX's compacted one with JAX's noise injected (1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from brepgen_tpu.cli.build import build_denoiser as j_build_denoiser
from brepgen_tpu.sampling import CascadeConfig as JCascadeConfig
from brepgen_tpu.sampling import build_cascade
from brepgen_tpu_torch import nn as tnn
from brepgen_tpu_torch.cli import sample_main
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, GeneratorNoise
from brepgen_tpu_torch.sampling import cascade
from test_torch_port_sampling import JaxDraws, _models
from test_torch_port_weights import STREAMS, _flax_tree

ROOT = os.path.join(os.path.dirname(__file__), "..")
EVAL_CONFIG = os.path.join(ROOT, "eval_config_tpu.yaml")
ROUND5 = os.path.join(ROOT, "artifacts", "demo_round5")
ALL160K, CF160K, HELD160K = (os.path.join(ROUND5, name, "ckpt_packed")
                             for name in ("all160k", "cf160k", "held160k"))


# --- F1: --config, the presets and the class label -------------------------

def test_config_reader_matches_yaml():
    got = cascade.read_eval_config(EVAL_CONFIG)
    with open(EVAL_CONFIG) as f:
        want = yaml.safe_load(f)
    assert sorted(got) == sorted(want) == ["abc", "deepcad", "furniture"]
    for mode in want:
        for key in cascade.CONFIG_KEYS:
            assert got[mode][key] == want[mode][key], (mode, key)
            assert type(got[mode][key]) is type(want[mode][key]), (mode, key)
    assert got == want


def test_config_reader_forms_match_yaml(tmp_path):
    path = tmp_path / "eval.yaml"
    path.write_text(
        "# a comment line\n"
        "abc:\n"
        "  num_surfaces:   70   # trailing comment\n"
        "  num_edges: 60\n"
        "  use_cf: no\n"
        "  z_threshold: 0.25\n"
        "  class_label: 'bench'\n"
        "  save_folder: \"samples abc\"\n"
        "  tags: [1, 2.5, chair]\n"
        "  empty:\n"
        "\n"
        "furniture:\n"
        "  use_cf: True\n"
        "  class_label: sofa#not a comment\n")
    with open(path) as f:
        assert cascade.read_eval_config(path) == yaml.safe_load(f)


def test_presets_take_the_eval_config_values():
    with open(EVAL_CONFIG) as f:
        want = yaml.safe_load(f)
    for mode, preset in cascade.MODE_PRESETS.items():
        assert preset == {k: want[mode][k] for k in cascade.CONFIG_KEYS}, mode
        cfg = CascadeConfig.for_mode(mode)
        assert cfg == CascadeConfig.for_mode(mode, config=EVAL_CONFIG)
        assert (cfg.batch_size, cfg.z_threshold, cfg.bbox_threshold) == (16, 0.2, 0.08)
    assert CascadeConfig.for_mode("furniture").class_label == 6
    assert CascadeConfig.for_mode("abc").class_label == 0


def test_cli_config_overrides_the_preset(tmp_path):
    path = tmp_path / "long.yaml"
    path.write_text("abc:\n  num_surfaces: 70\n  num_edges: 60\n  batch_size: 2\n"
                    "  bbox_threshold: 0.1\n  surfpos_weight: proj_log/unused\n")
    args = sample_main.parse_args(["--config", str(path), "--weights_dir", ALL160K,
                                   "--device", "cpu", "--max_batches", "1", "--compact",
                                   "--fast_steps", "3"])
    assert args.mode == "abc"  # the reference's default
    cfg = sample_main.cascade_from_args(args).cfg
    assert (cfg.num_surfaces, cfg.num_edges, cfg.faces) == (70, 60, 140)
    assert (cfg.batch_size, cfg.bbox_threshold, cfg.z_threshold) == (2, 0.1, 0.2)
    assert cfg.compact and cfg.fast_steps == 3
    args = sample_main.parse_args(["--config", str(path), "--batch_size", "5", "--max_batches",
                                   "1"])
    assert CascadeConfig.for_mode(args.mode, args.batch_size, args.config).batch_size == 5
    with pytest.raises(ValueError, match="class_label"):
        cascade.class_label_id("chiar")


def _tiny_cf_nets(gen):
    small = dict(width=32, num_heads=2, ffn_width=64, num_layers=1)
    nets = {s: seed_weights(getattr(tnn, f"make_{s}_net")(use_cf=True, **small), gen).eval()
            for s in STREAMS}
    vaes = [seed_weights(m, gen).eval() for m in (tnn.SurfVAE((4, 4, 4, 4)),
                                                  tnn.EdgeVAE((4, 4, 4)))]
    return nets, vaes


def test_furniture_cfg_halves_differ(monkeypatch):
    """The CFG batch carries the chair label in its first half and 0 in its
    second, so the two halves of every prediction differ."""
    monkeypatch.setitem(cascade.MODE_PRESETS, "furniture",
                        dict(cascade.MODE_PRESETS["furniture"], num_surfaces=3, num_edges=2))
    nets, vaes = _tiny_cf_nets(torch.Generator().manual_seed(0))
    halves = []
    for stage, net in nets.items():
        denoise = net.denoise

        def spy(noisy, t, cond, mask, labels, denoise=denoise):
            pred = denoise(noisy, t, cond, mask, labels)
            B = pred.shape[0] // 2
            halves.append((labels[:B].unique().tolist(), labels[B:].unique().tolist(),
                           (pred[:B] - pred[B:]).abs().max().item()))
            return pred

        monkeypatch.setattr(net, "denoise", spy)
    cfg = CascadeConfig.for_mode("furniture", batch_size=2, fast_steps=2)
    Cascade(nets, *vaes, cfg)(GeneratorNoise(torch.Generator().manual_seed(1)))
    assert halves and all(h[:2] == ([6], [0]) for h in halves)
    assert min(h[2] for h in halves) > 1e-3


# --- F2: the class-conditional packs ---------------------------------------

@pytest.fixture(scope="module")
def cf_cascade():
    return sample_main.init_cascade("furniture", CF160K, batch_size=2, device="cpu")


def test_cf160k_packs_load(cf_cascade):
    assert cf_cascade.cfg.use_cf and cf_cascade.cfg.class_label == 6
    for stage, net in cf_cascade.nets.items():
        assert net.class_embed.weight.shape == (4, 256), stage
    # chair (6) is not among the packs' 4 classes: sampling says so
    with pytest.raises(ValueError, match="outside the 4 classes"):
        cf_cascade(GeneratorNoise(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("stage", list(STREAMS))
def test_cf160k_denoiser_with_labels_matches_jax(cf_cascade, stage):
    path = os.path.join(CF160K, f"{stage}.npz")
    jm = j_build_denoiser(stage, use_cf=True, num_classes=4, width=256, num_heads=8,
                          ffn_width=512, num_layers=6)
    rng = np.random.default_rng(len(stage))
    B, S = 3, 10
    streams = [rng.normal(size=(B, S, d)).astype(np.float32) for d in STREAMS[stage]]
    t = np.array([3, 700, 250], np.int32)
    mask = np.zeros((B, S), bool)
    mask[1, 6:] = True
    labels = np.array([[1], [3], [0]], np.int32)
    want = jm.apply(_flax_tree(path), tuple(map(jnp.asarray, streams)), jnp.asarray(t),
                    jnp.asarray(mask), jnp.asarray(labels))
    with torch.no_grad():
        got = cf_cascade.nets[stage]([torch.from_numpy(s) for s in streams], torch.from_numpy(t),
                                     torch.from_numpy(mask), torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_held160k_packs_load():
    c = sample_main.init_cascade("deepcad", HELD160K, batch_size=2, device="cpu")
    assert not c.cfg.use_cf
    assert c.nets["edgez"].width == 256


# --- face-token compaction --------------------------------------------------

PNDM = dict(batch_size=3, num_surfaces=4, num_edges=3, pndm_steps=10, pos_pndm_calls=8,
            ddpm_tail=0)


@pytest.mark.parametrize("threshold,counts,bucket", [
    (100.0, [1, 1, 1], 2),   # every face but slot 0 dedups away
    (1.0, [4, 4, 4], 4),     # the duplicated half dedups away
    (5.0, [3, 4, 4], 4),     # ragged kept counts
])
def test_compaction_matches_uncompacted(threshold, counts, bucket):
    port = _models(False)[1]
    outs = []
    for compact in (False, True):
        cfg = CascadeConfig(bbox_threshold=threshold, compact=compact, compact_granularity=2,
                            **PNDM)
        c = Cascade(*port, cfg)
        out = c(GeneratorNoise(torch.Generator().manual_seed(0)))
        outs.append({k: v.numpy() for k, v in out.items()})
        assert c.last_bucket == (bucket if compact else cfg.faces)
    plain, comp = outs
    keep = ~plain["surf_mask"]
    assert keep.sum(axis=1).tolist() == counts
    np.testing.assert_array_equal(comp["surf_mask"], plain["surf_mask"])
    np.testing.assert_array_equal(comp["edge_mask"][keep], plain["edge_mask"][keep])
    for k in ("surf_pos", "surf_z", "surf_ncs"):
        np.testing.assert_array_equal(comp[k], plain[k], err_msg=k)
    for k in ("edge_pos", "edge_z", "edge_v", "edge_ncs"):
        np.testing.assert_allclose(comp[k][keep], plain[k][keep], atol=1e-4, rtol=0, err_msg=k)
    # slots outside the bucket come back as zeros with every edge masked
    outside = np.abs(comp["edge_pos"]).max(axis=(2, 3)) == 0
    assert (outside.sum(axis=1) >= 8 - bucket).all()
    assert comp["edge_mask"][outside].all()


def test_compacted_cascade_matches_jax():
    """JAX's compacted cascade and the port's on the PNDM + DDPM protocol,
    with JAX's draws: the initial noise at the full shape gathered, the DDPM
    tail at the bucket's shape."""
    models = _models(False)
    cfg_kw = dict(batch_size=2, num_surfaces=4, num_edges=3, pndm_steps=10, pos_pndm_calls=8,
                  ddpm_tail=5, bbox_threshold=100.0, compact=True, compact_granularity=2)
    jcfg = JCascadeConfig(**cfg_kw)
    key = jax.random.PRNGKey(5)
    want = {k: np.asarray(v) for k, v in build_cascade(*models[0], jcfg)(key).items()}
    tc = Cascade(*models[1], CascadeConfig(**cfg_kw))
    got = {k: v.numpy() for k, v in tc(JaxDraws(key, jcfg, jcfg.ddpm_tail)).items()}
    assert tc.last_bucket == 2 < tc.cfg.faces
    for k in ("surf_mask", "edge_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
