"""The guided cascade on the cf160k packs' own weights against JAX's.

Fault F5 (cf160k prism strict validity under its band) asks whether the
port's class-conditional cascade differs from the JAX one on the packs that
showed it. Here both run on ``artifacts/demo_round5/cf160k/ckpt_packed`` (6
layers, width 256, 4 classes) at ``resample_main --cf``'s size (10 faces x 8
edges, as ``scripts/resample_demo.py`` builds it), class 2 (prism), CFG
weight 0.6, batch 2, f32, with JAX's draws replayed into the port: a few
DDIM steps, and a short PNDM + DDPM protocol. Masks must be identical and
values within 5e-4 (measured: 2.1e-4 at most, in edge_z). The tiny seeded
cascade holds 1e-4; here the trained packs' latents reach 6 and the early
DDIM / PNDM steps divide eps by sqrt(alpha_bar) ~ 0.006, so f32 rounding
alone moves the outputs by about 1e-4: one ulp added to every initial noise
draw of the port moves surf_z by 1.3e-4 in the protocol and edge_z by
3.8e-5 in DDIM. A second test holds ``resample_main --cf``'s
``CascadeConfig`` for each class and weight to the one the JAX script
builds (the seeds feed different generators, which the port documents).
"""

import ast
import os
import types

import jax
import numpy as np
import pytest
import torch

from brepgen_tpu.cli.build import build_denoiser as j_build_denoiser
from brepgen_tpu.nn import EdgeVAE as JEdgeVAE
from brepgen_tpu.nn import SurfVAE as JSurfVAE
from brepgen_tpu.sampling import CascadeConfig as JCascadeConfig
from brepgen_tpu.sampling import build_cascade
from brepgen_tpu_torch.cli import resample_main
from brepgen_tpu_torch.cli.sample_main import load_models
from brepgen_tpu_torch.diffusion import make_ddim_plan
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig
from test_torch_port_sampling import JaxDraws
from test_torch_port_weights import STREAMS, _flax_tree

ROOT = os.path.join(os.path.dirname(__file__), "..")
CF160K = os.path.join(ROOT, "artifacts", "demo_round5", "cf160k", "ckpt_packed")
DEMO_SCRIPT = os.path.join(ROOT, "scripts", "resample_demo.py")
NF, NE = 10, 8  # resample_main's --max_face / --max_edge defaults, the packs' training size
PRISM, W = 2, 0.6


@pytest.fixture(autouse=True)
def two_threads():
    # at most two threads for the port's side: the test runs beside other
    # test workers, where more threads on these small products only contend
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _jax_side():
    kw = dict(use_cf=True, num_classes=4, width=256, num_heads=8, ffn_width=512, num_layers=6)
    nets = {s: j_build_denoiser(s, **kw) for s in STREAMS}
    params = {s: _flax_tree(os.path.join(CF160K, f"{s}.npz")) for s in STREAMS}
    surf_vae = JSurfVAE(block_out_channels=(32, 64, 128, 128))
    edge_vae = JEdgeVAE(block_out_channels=(32, 64, 128))
    return (nets, params,
            lambda p, z: surf_vae.apply(p, z, method=JSurfVAE.decode),
            _flax_tree(os.path.join(CF160K, "surf_vae.npz")),
            lambda p, z: edge_vae.apply(p, z, method=JEdgeVAE.decode),
            _flax_tree(os.path.join(CF160K, "edge_vae.npz")))


@pytest.mark.parametrize("fast_steps", [4, 0])
def test_cf160k_guided_cascade_matches_jax(fast_steps):
    cfg_kw = dict(batch_size=2, num_surfaces=NF, num_edges=NE, use_cf=True,
                  class_label=PRISM, cfg_weight=W, fast_steps=fast_steps)
    if not fast_steps:  # the protocol's phases, shortened
        cfg_kw.update(pndm_steps=10, pos_pndm_calls=8, ddpm_tail=5)
    jcfg = JCascadeConfig(**cfg_kw)
    key = jax.random.PRNGKey(7)
    want = {k: np.asarray(v) for k, v in build_cascade(*_jax_side(), jcfg)(key).items()}
    nets, surf_vae, edge_vae = load_models(True, CF160K, device="cpu")
    tcascade = Cascade(nets, surf_vae, edge_vae, CascadeConfig(**cfg_kw))
    if fast_steps:
        surfpos_tail = int(make_ddim_plan(fast_steps).t[max(fast_steps * 3 // 4, 1) - 1])
    else:
        surfpos_tail = jcfg.ddpm_tail
    got = {k: v.numpy() for k, v in tcascade(JaxDraws(key, jcfg, surfpos_tail)).items()}
    assert sorted(got) == sorted(want)
    for k in ("surf_mask", "edge_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (~got["surf_mask"]).sum() > 0 and (~got["edge_mask"]).sum() > 0
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=5e-4, rtol=0, err_msg=k)


def _demo_cf_config(cls, w):
    """The ``CascadeConfig(...)`` call of ``resample_demo.py``'s ``--cf``
    branch, evaluated with the script's names bound (JAX's CascadeConfig)."""
    tree = ast.parse(open(DEMO_SCRIPT).read())
    calls = [n for b in tree.body if isinstance(b, ast.If) and ast.unparse(b.test) == "args.cf"
             for n in ast.walk(ast.Module(b.body, [])) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == "CascadeConfig"]
    assert len(calls) == 1, [ast.unparse(c) for c in calls]
    call = calls[0]
    return eval(compile(ast.Expression(call), DEMO_SCRIPT, "eval"),
                {"CascadeConfig": JCascadeConfig, "NF": NF, "NE": NE, "cls": cls, "w": w})


def test_resample_cf_config_equals_the_demo_script(monkeypatch, tmp_path):
    seen = []

    def generate(cascade, batches, seed, dump_path=None):
        seen.append((cascade.cfg, seed))
        return []

    monkeypatch.setattr(resample_main, "generate", generate)
    monkeypatch.setattr(resample_main, "postprocess", lambda *a, **k: {})
    vae = types.SimpleNamespace(decode=None)
    monkeypatch.setattr(resample_main, "load_models", lambda *a, **k: ({}, vae, vae))
    monkeypatch.setattr(resample_main, "make_padded_decoder", lambda *a, **k: None)
    args = resample_main.parse_args(["--weights_dir", CF160K, "--out", str(tmp_path), "--cf",
                                     "--cfg_weights", "0.6", "1.2", "--device", "cpu"])
    resample_main.run(args)
    pairs = [(w, cls) for w in (0.6, 1.2) for cls in (1, 2, 3)]
    assert len(seen) == len(pairs)
    common = set(CascadeConfig.__dataclass_fields__) & set(JCascadeConfig.__dataclass_fields__)
    assert {"num_surfaces", "num_edges", "use_cf", "class_label", "cfg_weight",
            "pndm_steps", "ddpm_tail", "fast_steps"} <= common
    for (w, cls), (cfg, seed) in zip(pairs, seen):
        want = _demo_cf_config(cls, w)
        for field in sorted(common):
            assert getattr(cfg, field) == getattr(want, field), (w, cls, field)
        # the JAX script's key base; here it seeds a torch.Generator
        assert seed == 5000 + 100 * cls + int(w * 10) * 1000
    # --seed moves the base
    seen.clear()
    resample_main.run(resample_main.parse_args(
        ["--weights_dir", CF160K, "--out", str(tmp_path), "--cf", "--classes", "2", "--seed",
         "9000", "--device", "cpu"]))
    assert [s for _, s in seen] == [9000 + 200 + 6000]
