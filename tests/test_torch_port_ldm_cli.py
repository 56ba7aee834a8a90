"""Port: the LDM training CLI on the CPU, end to end.

``ldm_main --small --synthetic 8`` trains each stage on synthetic solids
through the port's own data path and writes ``epoch_N.npz``; the JAX
package loads that pack and its forward equals the port's (1e-4, f32).
``--resume`` continues the step count; ``--dp`` outside a torchrun launch
exits with a message naming torchrun (``test_torch_port_parallel.py`` runs
it under torchrun).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.nn import denoiser as jden
from brepgen_tpu.train.checkpoint import load_params as j_load_params
from brepgen_tpu_torch.cli import ldm_main
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE
from brepgen_tpu_torch.nn import denoiser as tden
from brepgen_tpu_torch.train.checkpoint import load_params, save_params_npz

SMALL = dict(width=32, num_heads=2, ffn_width=64, num_layers=1)


@pytest.fixture(autouse=True)
def one_thread():
    # one thread keeps the runs short on a loaded CPU
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vae_packs(tmp_path_factory):
    folder = tmp_path_factory.mktemp("vaes")
    gen = torch.Generator().manual_seed(0)
    surf = save_params_npz(str(folder), seed_weights(SurfVAE((8, 8, 8, 8)), gen), "surfvae")
    edge = save_params_npz(str(folder), seed_weights(EdgeVAE((8, 8, 8)), gen), "edgevae")
    return surf, edge[:-len(".npz")]  # the extension may be left off, as in JAX


def _argv(tmp_path, vae_packs, option, *extra):
    return ["--small", "--synthetic", "8", "--option", option, "--train_nepoch", "1",
            "--device", "cpu", "--batch_size", "4", "--max_face", "10", "--max_edge", "8",
            "--num_workers", "0", "--test_nepoch", "1", "--surfvae", vae_packs[0],
            "--edgevae", vae_packs[1], "--dir_name", str(tmp_path), "--env", option, *extra]


@pytest.mark.parametrize("option", ["surfpos", "surfz", "edgepos", "edgez"])
def test_cli_writes_a_pack_jax_loads(tmp_path, vae_packs, option):
    state = ldm_main.main(_argv(tmp_path, vae_packs, option))
    folder = tmp_path / option
    assert state.step == 2  # 8 solids, batch 4, drop_last
    assert sorted(os.listdir(folder)) == sorted(["epoch_1.npz", "latest.pt", f"{option}.jsonl"])
    with open(folder / f"{option}.jsonl") as f:
        text = f.read()
    assert '"Val-010"' in text and '"loss"' in text
    pack = str(folder / "epoch_1.npz")
    with np.load(pack) as raw:
        assert all(k.startswith("params/") and raw[k].dtype == np.float32 for k in raw.files)

    name = {"surfpos": "make_surfpos_net", "surfz": "make_surfz_net",
            "edgepos": "make_edgepos_net", "edgez": "make_edgez_net"}[option]
    jmodel = getattr(jden, name)(**SMALL)
    jparams = j_load_params(pack)
    tmodel = load_params(pack, getattr(tden, name)(**SMALL)).eval()
    rng = np.random.default_rng(1)
    S = 10 * (8 if option.startswith("edge") else 1)
    streams = [rng.normal(size=(2, S, d)).astype(np.float32)
               for d in tmodel.stream_dims.values()]
    mask = np.zeros((2, S), bool)
    mask[1, S // 2:] = True
    t = np.array([3, 700], np.int32)
    want = jmodel.apply(jparams, tuple(jnp.asarray(s) for s in streams), jnp.asarray(t),
                        jnp.asarray(mask))
    with torch.no_grad():
        got = tmodel(tuple(torch.from_numpy(s) for s in streams), torch.from_numpy(t),
                     torch.from_numpy(mask))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


def test_resume_continues_the_step_count(tmp_path, vae_packs):
    ldm_main.main(_argv(tmp_path, vae_packs, "surfpos"))
    state = ldm_main.main(_argv(tmp_path, vae_packs, "surfpos", "--resume"))
    assert state.step == 4
    fresh = ldm_main.main(_argv(tmp_path, vae_packs, "surfpos"))
    assert fresh.step == 2


@pytest.mark.parametrize("flag", [["--cache_latents"], ["--dp"], ["--profile", "trace"],
                                  ["--remat", "dots"]])
def test_unported_options_exit_with_a_message(tmp_path, vae_packs, flag, monkeypatch):
    # --dp needs a torchrun launch and, outside one, exits with a message
    # naming it; the other three pass the check
    args = ldm_main.get_args(_argv(tmp_path, vae_packs, "edgez", *flag))
    if flag == ["--dp"]:
        for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(var, raising=False)
        with pytest.raises(SystemExit, match=r"torchrun --nproc_per_node N -m "
                                             r"brepgen_tpu_torch\.cli\.ldm_main --dp"):
            ldm_main.refuse_unported(args)
        with pytest.raises(SystemExit, match="torchrun"):
            ldm_main.main(_argv(tmp_path, vae_packs, "edgez", *flag))
    else:
        ldm_main.refuse_unported(args)


def test_cli_refuses_without_a_card(tmp_path, vae_packs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path, vae_packs, "surfpos") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ldm_main.main(argv)
