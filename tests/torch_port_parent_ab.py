"""Card A/B of the attention kernels against an earlier commit's, in one
process on one card (not collected by pytest; needs a CUDA card and nvcc).

    git archive <commit> brepgen_tpu_torch | tar -x -C build/parent
    python tests/torch_port_parent_ab.py kernels build/parent
    python tests/torch_port_parent_ab.py memory build/parent \\
        artifacts/demo_round5/all160k/ckpt_packed

``kernels`` builds the earlier commit's ``packed_attention.cu``,
``set_attention.cu`` and ``packed_attention_bwd.cu`` from PARENT (their C
interfaces as they were before K1 wrote training residuals) and, on the
same inputs: holds K1's sampling output (no residuals) to the earlier
kernel's bit for bit in f32 and bf16 at three shapes; times K5 (the earlier
one given K1's output, this one given K1's residuals) and K3 bf16 against
the earlier ones in turns (earlier, this, this, earlier), beside SDPA.
``memory`` runs one edgez step at B=128, 30 x 20 slots (synthetic solids
from seed 5, latents from the VAE packs in PACKS), remat on / dots / off,
in f32 and under bf16 autocast, for each package in its own process
(earlier, this, earlier, this), and prints the peak memory and the ms of
three more steps. Every line names the card and its power limit.
"""

import ctypes
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line():
    # not brepgen_tpu_torch.nvidia_smi_card: ``memory`` runs this script under
    # an earlier package, which may not have it
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def earlier_library(parent, name, argtypes, fn_name):
    from brepgen_tpu_torch.kernels import _build

    so = os.path.join(parent, f"lib{name}_earlier.so")
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([_build.find_nvcc(), *flags, "-o", so,
                    os.path.join(parent, "brepgen_tpu_torch", "kernels", "csrc", name + ".cu")],
                   check=True)
    fn = getattr(ctypes.CDLL(so), fn_name)
    fn.argtypes = argtypes
    return fn


def kernels(parent):
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, ROOT)
    import chip_smoke
    from brepgen_tpu_torch.kernels.attention import (packed_attention,
                                                     packed_attention_backward,
                                                     packed_attention_with_stats)
    from brepgen_tpu_torch.kernels.set_attention import set_attention

    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    k1 = earlier_library(parent, "packed_attention", [P] * 3 + [I] * 5 + [Fl, P],
                         "packed_attention_forward")
    k3 = earlier_library(parent, "set_attention", [P] * 5 + [I] * 5 + [Fl, P],
                         "set_attention_forward")
    k5 = earlier_library(parent, "packed_attention_bwd", [P] * 6 + [I] * 5 + [Fl, P],
                         "packed_attention_backward")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    t = lambda fn, n: chip_smoke.time_ms(torch, fn, n)  # noqa: E731
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, W, H in ((16, 1800, 768, 12), (4, 601, 256, 8), (2, 8400, 768, 12)):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((B, S, 3 * W), generator=gen, device="cuda").to(dtype)
            mask = chip_smoke.make_masks(torch, B, S, gen)
            with torch.no_grad():
                new = packed_attention(qkv, H, mask)
            old = torch.empty_like(new)
            assert k1(qkv.data_ptr(), mask.view(torch.uint8).data_ptr(), old.data_ptr(), B, S, W,
                      H, int(dtype == torch.bfloat16), 1.0 / math.sqrt(W // H), stream()) == 0
            torch.cuda.synchronize()
            same = torch.equal(new, old)
            print(f"K1 sampling output B={B} S={S} W={W} H={H} {dtype}: bit-equal to the "
                  f"earlier kernel's: {same} ({card})", flush=True)
            assert same
    for B, S, W, H in ((128, 600, 768, 12), (64, 160, 256, 8)):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((B, S, 3 * W), generator=gen, device="cuda").to(dtype)
            dout = torch.randn((B, S, W), generator=gen, device="cuda").to(dtype)
            mask = chip_smoke.make_masks(torch, B, S, gen)
            fwd, o32, stats = packed_attention_with_stats(qkv, H, mask)
            scratch = torch.empty((B, H, S, 3), device="cuda")
            out_old = torch.empty_like(qkv)

            def old():
                assert k5(qkv.data_ptr(), dout.data_ptr(), fwd.data_ptr(),
                          mask.view(torch.uint8).data_ptr(), scratch.data_ptr(),
                          out_old.data_ptr(), B, S, W, H, int(dtype == torch.bfloat16),
                          1.0 / math.sqrt(W // H), stream()) == 0

            new = lambda: packed_attention_backward(  # noqa: E731
                qkv, dout, H, mask, out=o32, stats=stats)
            q, k, v = (a.detach().requires_grad_() for a in chip_smoke.split_heads(qkv, H))
            g = dout.reshape(B, S, H, W // H).transpose(1, 2)
            bias = torch.where(mask[:, None, None, :], -1e9, 0.0).to(dtype)
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            sdpa = lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True)  # noqa
            r = [t(old, 10), t(new, 10), t(new, 10), t(old, 10), t(sdpa, 5)]
            diff = (new().float() - out_old.float()).abs().max().item()
            print(f"K5 B={B} S={S} W={W} H={H} {dtype}: earlier {r[0]:.4f} / {r[3]:.4f} ms, "
                  f"this {r[1]:.4f} / {r[2]:.4f} ms, SDPA backward {r[4]:.4f} ms; max |this - "
                  f"earlier| {diff:.3e} ({card})", flush=True)
            del q, k, v, o, g, bias, qkv, dout, fwd, o32, stats, scratch, out_old
            torch.cuda.empty_cache()
    for B, S, W, H in ((16, 4000, 768, 12), (4, 4000, 256, 8)):
        qkv = torch.randn((B, S, 3 * W), generator=gen, device="cuda").to(torch.bfloat16)
        mask = chip_smoke.make_masks(torch, B, S, gen)
        q, k, v = (a.contiguous() for a in chip_smoke.split_heads(qkv, H))
        out_old = torch.empty_like(q)

        def old():
            assert k3(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.view(torch.uint8).data_ptr(),
                      out_old.data_ptr(), B, H, S, W // H, 1, 1.0 / math.sqrt(W // H),
                      stream()) == 0

        bias = torch.where(mask[:, None, None, :], -1e9, 0.0).to(torch.bfloat16)
        with torch.no_grad():
            new = lambda: set_attention(q, k, v, mask)  # noqa: E731
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)  # noqa
            r = [t(old, 20), t(new, 20), t(new, 20), t(old, 20), t(sdpa, 5)]
            diff = (new().float() - out_old.float()).abs().max().item()
        print(f"K3 bf16 B={B} S={S} W={W} H={H}: earlier {r[0]:.4f} / {r[3]:.4f} ms, this "
              f"{r[1]:.4f} / {r[2]:.4f} ms, SDPA {r[4]:.4f} ms; max |this - earlier| "
              f"{diff:.3e} ({card})", flush=True)


def memory_one(packs, label):
    """The step's peaks and times for the package on sys.path."""
    import torch

    from brepgen_tpu_torch.cli import ldm_main
    from brepgen_tpu_torch.cli.build import build_denoiser, seed_weights
    from brepgen_tpu_torch.data.batch_assembly import assemble_edgez_batched
    from brepgen_tpu_torch.data.synthetic import make_dataset
    from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
    from brepgen_tpu_torch.train import ldm_train
    from brepgen_tpu_torch.train.common import TrainState
    from brepgen_tpu_torch.train.vae_train import make_encoder_fn

    card = card_line()
    raw = assemble_edgez_batched(make_dataset(128, seed=5), list(range(128)), max_face=30,
                                 max_edge=20)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in zip(ldm_main.BATCH_KEYS["edgez"], raw)}
    enc = {o: make_encoder_fn(ldm_main.load_vae(o, os.path.join(packs, f), "cuda"))
           for o, f in (("surface", "surf_vae.npz"), ("edge", "edge_vae.npz"))}
    batch["surfz"] = ldm_train.encode_surf(enc["surface"], batch.pop("surfpnt"))
    batch["edgez"] = ldm_train.encode_edge(enc["edge"], batch.pop("edgepnt"))
    del enc

    class ZeroGrad:  # an optimizer stand-in: the step's memory without AdamW's state
        def __init__(self, module):
            self.module = module

        def step(self):
            self.module.zero_grad(set_to_none=True)

    for dtype in (None, torch.bfloat16):
        for remat in (True, "dots", False):
            net = seed_weights(build_denoiser("edgez", remat=remat),
                               torch.Generator().manual_seed(2)).to("cuda")
            step = ldm_train.make_edgez_step(net, make_ddpm_tables(), None, None,
                                             compute_dtype=dtype)
            state = TrainState(net, ZeroGrad(net))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(state, batch, torch.Generator().manual_seed(3))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            t0 = time.perf_counter()
            for _ in range(3):
                step(state, batch, torch.Generator().manual_seed(3))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 3 * 1e3
            print(f"{label} edgez B=128 {'bf16' if dtype else 'f32'} remat={remat}: peak "
                  f"{peak:.2f} GiB, {ms:.1f} ms a step ({card})", flush=True)
            del net, step, state
            torch.cuda.empty_cache()


def memory(parent, packs):
    for root, label in ((parent, "earlier"), (ROOT, "this"), (parent, "earlier"),
                        (ROOT, "this")):
        subprocess.run([sys.executable, os.path.abspath(__file__), "_memory_one",
                        os.path.abspath(packs), label],
                       cwd=root, env=dict(os.environ, PYTHONPATH=os.path.abspath(root)),
                       check=True)


if __name__ == "__main__":
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd == "kernels":
        kernels(os.path.abspath(args[0]))
    elif cmd == "memory":
        memory(os.path.abspath(args[0]), args[1])
    elif cmd == "_memory_one":
        memory_one(*args)
    else:
        raise SystemExit(f"unknown command {cmd}: kernels PARENT | memory PARENT PACKS")
