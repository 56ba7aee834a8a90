"""Training cells: the edgez train step of ``brepgen_tpu_torch.train.ldm_train``
as the training CLI runs it.

Set-up builds one training object: the edgez denoiser at the configuration's
widths (per-layer recompute where the CLI's ``auto_remat`` turns it on), the
clipped AdamW of ``train/common.py``, the frozen surface and edge VAEs'
encodes in the configuration's type (each wrapped in a benchmark span), the
step of ``make_edgez_step`` under autocast, and the CLI's CPU generator for
the step's draws, seeded from the run's seed. It makes a few batches on the
device from the seed (N(0, 1) grids, boxes and vertices, every slot valid,
as ``tools/train_step_bench.py:build_batch``) and cycles them. Set-up drives
the object through its first three steps, on three different batches, and
keeps its state as the window finds it: the parameters, AdamW's moments and
count of steps, and the CPU generator. The same object then runs the window:
steps back to back, at least three, the last one that starts inside the
window runs to its end. Of the window's first three steps, on three
different batches, the run keeps what the check compares: each step's loss,
the first clipped gradient as the optimizer got it (from AdamW's first
moment before and after it) and the parameters after the third, each copied
to the host behind the step without waiting for it.

The check runs the reference's three steps from that state, on the same
batches (``reference/train.py``), and compares the losses (``loss_gap``, the
worst step), the first gradient (``grad_gap``) and the parameters' change
over the three steps (``update_gap``), each of the last two by the worst
leaf.
"""

from __future__ import annotations

import time

import torch

from gpubench import counts, trace
from gpubench.kinds.common import DTYPES, architecture, build, free_cuda, seeds, worst
from gpubench.reference import train as ref_train
from gpubench.reference import vae as ref_vae
from gpubench.reference.precision import exact

WARMUP_STEPS = 3  # steps of set-up
CHECK_STEPS = 3  # the window's first steps, which the check compares
TRACE_STEPS = 2
# an element whose reference gradient is under this share of the median
# leaf's RMS gradient moves under Adam by a sign that rounding decides (the
# key third of each fused qkv bias, nought to rounding under softmax; at
# seeded weights also much of the key weights): the change leaves it out
STILL_SHARE = 1e-3


def make_batch(gen: torch.Generator, B: int, nf: int, ne: int, device) -> dict:
    r = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    return {
        "edgepnt": r(B, nf, ne, 32, 3),
        "edgepos": r(B, nf, ne, 6),
        "edge_mask": torch.zeros((B, nf, ne), dtype=torch.bool, device=device),
        "surfpnt": r(B, nf, 32, 32, 3),
        "surfpos": r(B, nf, 6),
        "vertpos": r(B, nf, ne, 6),
    }


class Run:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        self.mix, self.device = mix, device
        self.tr = dict(config["training"])
        self.arch = architecture(config, device)
        if device.type == "cpu":  # a rehearsal's size
            self.tr.update(batch_size=4, max_face=4, max_edge=3)
        self.dtype = DTYPES[self.tr["dtype"]]
        self.weight_seed, self.data_seed, self.step_seed = seeds(seed, 3)
        self.steps = 0

    def setup(self) -> None:
        from brepgen_tpu_torch.cli.build import auto_remat, build_denoiser
        from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
        from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE
        from brepgen_tpu_torch.train import ldm_train
        from brepgen_tpu_torch.train.common import TrainState, make_ldm_optimizer
        from brepgen_tpu_torch.train.vae_train import make_encoder_fn

        tr, den = self.tr, self.arch["denoiser"]
        B, nf, ne = tr["batch_size"], tr["max_face"], tr["max_edge"]
        remat = auto_remat("edgez", B, nf, ne)
        makers = {"edgez": lambda: build_denoiser("edgez", False, remat=remat,
                                                  dropout=tr["dropout"], **den),
                  "surf_vae": lambda: SurfVAE(block_out_channels=tuple(self.arch["surface_vae"])),
                  "edge_vae": lambda: EdgeVAE(block_out_channels=tuple(self.arch["edge_vae"]))}
        modules, self.params = build(makers, self.weight_seed, self.device)
        del self.params["edgez"]  # the check starts from the state the window finds
        model = modules["edgez"].train()
        self.model = model
        opt = make_ldm_optimizer(model.parameters(), lr=tr["lr"], weight_decay=tr["weight_decay"],
                                 clip=tr["clip"])
        self.state = TrainState(model, opt)
        dtype = None if self.dtype == torch.float32 else self.dtype
        encoders = []
        for name in ("surf_vae", "edge_vae"):
            encode = make_encoder_fn(modules[name].requires_grad_(False), dtype)

            def spanned(x, _f=encode, _n=f"train.encode_{name[:4]}"):
                with trace.span(_n):
                    return _f(x)
            encoders.append(spanned)
        self.step_fn = ldm_train.make_edgez_step(model, make_ddpm_tables(), *encoders,
                                                 compute_dtype=dtype)
        self.generator = torch.Generator().manual_seed(self.step_seed)
        gen = torch.Generator(device=self.device).manual_seed(self.data_seed)
        self.batches = [make_batch(gen, B, nf, ne, self.device)
                        for _ in range(int(self.mix["batches"]))]
        if len(self.batches) < CHECK_STEPS:
            raise ValueError(f"the mix needs {CHECK_STEPS} batches at least")
        for _ in range(WARMUP_STEPS):
            self._step()
        # the state the window starts from, and host buffers for what it keeps
        host = lambda p: torch.empty(p.shape, pin_memory=self.device.type == "cuda")  # noqa: E731
        self.named = list(model.named_parameters())
        self.start_step = self.steps
        self.start = {n: p.detach().to("cpu", copy=True) for n, p in self.named}
        self.start_moments = (self._moment("exp_avg", "cpu"), self._moment("exp_avg_sq", "cpu"),
                              int(self._adam_state(self.named[0][1]).get("step", 0)))
        self.start_generator = self.generator.get_state()
        self.state_beta1 = opt.adamw.param_groups[0]["betas"][0]
        self.moment_after_1 = {n: host(p) for n, p in self.named}
        self.after = {n: host(p) for n, p in self.named}
        self.losses = []

    def _adam_state(self, p) -> dict:
        return self.state.optimizer.adamw.state.get(p, {})

    def _moment(self, key: str, device) -> dict:
        """AdamW's ``key`` moment of every parameter on ``device`` (zeros
        where the optimizer holds none)."""
        return {n: self._adam_state(p).get(key, torch.zeros_like(p)).detach().to(device, copy=True)
                for n, p in self.named}

    def _keep(self, done: int, loss) -> None:
        """What the check compares, of the window's first steps, copied to
        the host behind the step."""
        if done > CHECK_STEPS:
            return
        self.losses.append(loss)
        if done == 1:
            for n, p in self.named:
                m = self._adam_state(p).get("exp_avg")
                if m is None:
                    self.moment_after_1[n].zero_()
                else:
                    self.moment_after_1[n].copy_(m, non_blocking=True)
        if done == CHECK_STEPS:
            for n, p in self.named:
                self.after[n].copy_(p.detach(), non_blocking=True)

    def _step(self):
        batch = self.batches[self.steps % len(self.batches)]
        self.steps += 1
        with trace.span("train.step"):
            return self.step_fn(self.state, batch, self.generator)["loss"]

    def window(self, seconds: float) -> dict:
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        first = self.steps
        t0 = time.perf_counter()
        while self.steps - first < CHECK_STEPS or time.perf_counter() - t0 < seconds:
            loss = self._step()
            self._keep(self.steps - first, loss)
        sync()
        elapsed = time.perf_counter() - t0
        done = self.steps - first
        B = self.tr["batch_size"]
        finite = bool(torch.isfinite(loss))
        peak = torch.cuda.max_memory_allocated() if self.device.type == "cuda" else None
        return {
            "metrics": {"train_samples_per_s": B * done / elapsed},
            "attempted": done,
            "failed": 0 if finite else done,
            "records": {"window_s": elapsed, "steps": done, "model_flops": self._flops() * done,
                        "dtype": "bf16" if self.dtype == torch.bfloat16 else "f32",
                        "peak_bytes": peak},
        }

    def _flops(self) -> int:
        """Model FLOPs of one step: the denoiser's forward and backward (3 x
        the forward, recompute not counted) and the frozen encodes' forward,
        counted on meta tensors."""
        tr, d = self.tr, self.arch["denoiser"]
        B, nf, ne = tr["batch_size"], tr["max_face"], tr["max_edge"]
        fwd = counts.denoiser_flops_per_eval(B, nf * ne, counts.STAGE_STREAMS["edgez"],
                                             counts.STAGE_OUT["edgez"], d["width"],
                                             d["ffn_width"], d["num_layers"])
        meta = {k: {n: torch.empty(v.shape, device="meta") for n, v in ps.items()}
                for k, ps in self.params.items()}
        enc = counts.model_flops(lambda: (
            ref_vae.surf_encode(meta["surf_vae"], torch.empty((B * nf, 32, 32, 3), device="meta"),
                                self.arch["surface_vae"]),
            ref_vae.edge_encode(meta["edge_vae"], torch.empty((B * nf * ne, 32, 3), device="meta"),
                                self.arch["edge_vae"])))
        return 3 * fwd + enc

    def traced(self) -> dict:
        def steps():
            for _ in range(TRACE_STEPS):
                self._step()
        _, summary = trace.traced(steps)
        tr, d = self.tr, self.arch["denoiser"]
        B, S, W = tr["batch_size"], tr["max_face"] * tr["max_edge"], d["width"]
        dtype = "bf16" if self.dtype == torch.bfloat16 else "f32"
        f_ops, f_bytes = counts.attention_fwd(B, S, W, dtype)
        b_ops, b_bytes = counts.attention_bwd(B, S, W, dtype)
        n = TRACE_STEPS * d["num_layers"]
        summary["work"] = {"attn_fwd_ops": f_ops * n, "attn_fwd_bytes": f_bytes * n,
                           "attn_bwd_ops": b_ops * n, "attn_bwd_bytes": b_bytes * n,
                           "dtype": dtype, "steps": TRACE_STEPS}
        return summary

    def release(self) -> None:
        self.state = self.step_fn = self.model = None
        free_cuda()

    def _reference(self, prec: str):
        """The reference's three steps from the state the window started
        from: (losses, first clipped gradient, parameters after the third
        step)."""
        tr, d = self.tr, self.arch["denoiser"]
        gen = torch.Generator()
        gen.set_state(self.start_generator)
        m, v, k0 = self.start_moments
        opt = ref_train.AdamW({n: p.to(self.device) for n, p in self.start.items()}, tr["lr"],
                              tuple(tr["betas"]), tr["eps"], tr["weight_decay"], tr["clip"],
                              state=(m, v, k0))
        losses = []
        for k in range(CHECK_STEPS):
            batch = self.batches[(self.start_step + k) % len(self.batches)]
            B, nf, ne = batch["edgepos"].shape[:3]
            latents = ref_train.encode(self.params, batch, self.arch["surface_vae"],
                                       self.arch["edge_vae"], prec)
            dr = ref_train.draws(gen, (B, nf, ne, 18),
                                 [(B, nf, ne, 6), (B, nf, 6), (B, nf, 48)], d["num_layers"])
            loss, grads = ref_train.loss_and_grads(opt.p, batch, latents, dr, d["num_heads"],
                                                   d["num_layers"], tr["dropout"], prec)
            losses.append(float(loss))
            opt.step(grads)
        return losses, opt.first, opt.p

    def _program(self):
        """The program's three steps as the window kept them: (losses, first
        clipped gradient, parameters after the third step), on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        b1 = self.state_beta1
        m0 = self.start_moments[0]
        first = {n: ((self.moment_after_1[n].double() - b1 * m0[n].double()) / (1 - b1))
                 .float().to(self.device) for n in self.start}
        after = {n: p.to(self.device) for n, p in self.after.items()}
        return [float(x) for x in self.losses], first, after

    def readings(self, control: bool = False) -> dict:
        """The program's three steps against the reference's; with
        ``control`` the reference's in fp8 stand in for the program's."""
        with exact("f32"):
            losses, first, after = self._reference("f32")
            if control:
                got_losses, got_first, got_after = self._reference("fp8")
            else:
                got_losses, got_first, got_after = self._program()
        loss_gaps = [abs(g - w) / abs(w) for g, w in zip(got_losses, losses)]
        names = list(first)
        grad = ref_train.per_leaf_gaps(got_first, first, names)
        # the change leaves out elements under STILL_SHARE of the median
        # leaf's RMS gradient (see above)
        rms = sorted(float(first[k].double().pow(2).mean().sqrt()) for k in names)
        floor = STILL_SHARE * rms[len(rms) // 2]
        live = {k: first[k].abs() >= floor for k in names}
        self.still = {k: int((~m).sum()) for k, m in live.items() if not bool(m.all())}
        p0 = {n: p.to(self.device) for n, p in self.start.items()}
        moving = [k for k in names if bool(live[k].any())]
        want = {k: (after[k] - p0[k])[live[k]] for k in moving}
        update = ref_train.per_leaf_gaps({k: (got_after[k] - p0[k])[live[k]] for k in moving},
                                         want, moving)

        def look(gaps, ref):  # the three worst leaves: gap, reference norm, size
            top = sorted(gaps, key=gaps.get, reverse=True)[:3]
            return [[k, gaps[k], float(torch.linalg.vector_norm(ref[k].double())),
                     ref[k].numel()] for k in top]
        self.look = getattr(self, "look", {})
        self.look["control" if control else "program"] = {"grad": look(grad, first),
                                                          "update": look(update, want)}
        return {"loss_gap": worst(*loss_gaps), "grad_gap": worst(*grad.values()),
                "update_gap": worst(*update.values()), "loss1_gap": worst(loss_gaps[0]),
                "grad_median_gap": _median(grad.values()),
                "update_median_gap": _median(update.values())}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2]

