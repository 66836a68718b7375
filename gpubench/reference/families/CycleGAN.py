"""The CycleGAN train step in plain PyTorch, as ganslate publishes it.

One step: G_AB and G_BA translate both domains and back (fake_B, fake_A,
rec_B, rec_A); the generators' loss is the LSGAN loss of each
discriminator on its fake against 1, plus lambda times the L1 cycle loss of
each domain; it is backpropagated with the discriminators frozen and Adam
updates both generators. Then the fakes go through the image pools (fake_B's
pool first, both drawing from one host generator), and each discriminator's
loss, LSGAN on its real batch against 1 plus on its pooled fake batch
against 0, updates both discriminators with Adam.

Batches are channels-last `(N, *spatial, C)` host or device tensors, as the
benchmark hands them to the program; the networks run channels-first.

A family file (`families/<the short name of the program's GAN class>.py`)
holds `NETWORKS` (each network's config section and direction or domain,
in the program's order), `SERVED` (the networks a deployment serves, the
first one answering), `LOSS_NAMES` (the program's `losses` keys that its
step sets), `settings(conf)` (the step's numbers from the config) and
`Model(networks, settings, device, dtype)` (the step).
"""

from typing import Dict, Optional

import torch

NETWORKS = {"G_AB": ("generator", "AB"), "G_BA": ("generator", "BA"),
            "D_B": ("discriminator", "B"), "D_A": ("discriminator", "A")}
SERVED = ("G_AB",)
LOSS_NAMES = ("G_AB", "G_BA", "cycle_A", "cycle_B", "D_B", "D_A")


def settings(conf) -> Dict:
    """The step's learning rates, betas, cycle weights and pool from the
    config. Raises for a loss the reference does not model."""
    gan = conf.train.gan
    opt = gan.optimizer
    if opt.adversarial_loss_type != "lsgan" or opt.lambda_identity or opt.proportion_ssim:
        raise ValueError("the reference CycleGAN has LSGAN, L1 cycles and no identity loss")
    return {"lr_G": float(opt.lr_G), "lr_D": float(opt.lr_D),
            "betas": (float(opt.beta1), float(opt.beta2)),
            "lambda_AB": float(opt.lambda_AB), "lambda_BA": float(opt.lambda_BA),
            "pool_size": int(gan.pool_size), "pool_seed": int(conf.train.seed)}


class ImagePool:
    """ganslate's history of fakes: while it holds fewer than `size` images
    an image is stored and returned; once full, with probability 1/2 it is
    returned as it is, else a stored image is returned and replaced by it.
    Each image takes a uniform and an index from `generator`, drawn for the
    whole batch first."""

    def __init__(self, size: int, generator: torch.Generator):
        self.size, self.generator = size, generator
        self.images, self.count = None, 0

    def query(self, images: torch.Tensor) -> torch.Tensor:
        if self.size == 0:
            return images
        if self.images is None:
            self.images = torch.zeros((self.size, *images.shape[1:]), dtype=images.dtype,
                                      device=images.device)
        u = torch.rand(images.shape[0], generator=self.generator).tolist()
        idx = torch.randint(self.size, (images.shape[0],), generator=self.generator).tolist()
        out = images.clone()
        for i in range(images.shape[0]):
            if self.count < self.size:
                self.images[self.count] = images[i]
                self.count += 1
            elif u[i] > 0.5:
                out[i] = self.images[idx[i]]
                self.images[idx[i]] = images[i]
        return out


def lsgan(pred: torch.Tensor, target: float) -> torch.Tensor:
    return (pred - target).square().mean()


def channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


class Model:
    """The four networks, two Adam optimizers and two pools of one run.

    `networks`: `{name: spec}` with `spec.build()` the reference network;
    `spec`: `settings(conf)`."""

    def __init__(self, networks: Dict, spec: Dict, device, dtype=torch.float32):
        self.nets = {k: networks[k].build().to(device, dtype) for k in NETWORKS}
        self.dtype = dtype
        self.spec = spec
        params = {g: [p for n in names for p in self.nets[n].parameters()]
                  for g, names in (("G", ("G_AB", "G_BA")), ("D", ("D_B", "D_A")))}
        self.optimizers = {g: torch.optim.Adam(params[g], lr=spec[f"lr_{g}"],
                                               betas=spec["betas"], eps=1e-8)
                           for g in params}
        generator = torch.Generator().manual_seed(spec["pool_seed"])
        self.pools = {d: ImagePool(spec["pool_size"], generator) for d in ("B", "A")}

    def load(self, weights: Dict[str, Dict[str, torch.Tensor]]):
        """Load the benchmark's weights (before the first step)."""
        with torch.no_grad():
            for name, net in self.nets.items():
                net.load_state_dict(weights[name], strict=True)

    def _frozen(self, names, frozen: bool):
        for n in names:
            for p in self.nets[n].parameters():
                p.requires_grad_(not frozen)

    def step(self, batch: Dict[str, torch.Tensor], grads: Optional[Dict] = None,
             keep: Optional[int] = None, optimize: bool = True) -> Dict[str, torch.Tensor]:
        """One train step; returns its losses. `grads`, when given, receives
        each parameter's gradient as the optimizer gets it, under
        `<network>.<parameter>`. `keep` takes the first `keep` samples of the
        batch only (a fault the benchmark's control measures). Without
        `optimize` no parameter moves (the graph alone, for counting on the
        meta device)."""
        nets, spec = self.nets, self.spec
        device = next(nets["G_AB"].parameters()).device
        real_A, real_B = (channels_first(torch.as_tensor(batch[k][:keep]).to(device, self.dtype))
                          for k in ("A", "B"))
        self._frozen(("D_B", "D_A"), True)
        fake_B, fake_A = nets["G_AB"](real_A), nets["G_BA"](real_B)
        rec_A, rec_B = nets["G_BA"](fake_B), nets["G_AB"](fake_A)
        losses = {"G_AB": lsgan(nets["D_B"](fake_B), 1.0),
                  "G_BA": lsgan(nets["D_A"](fake_A), 1.0),
                  "cycle_A": spec["lambda_AB"] * (rec_A - real_A).abs().mean(),
                  "cycle_B": spec["lambda_BA"] * (rec_B - real_B).abs().mean()}
        self.optimizers["G"].zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        self._frozen(("D_B", "D_A"), False)
        self._record(grads, ("G_AB", "G_BA"))
        if optimize:
            self.optimizers["G"].step()
        del rec_A, rec_B

        fake_B = self._pooled("B", fake_B.detach())
        fake_A = self._pooled("A", fake_A.detach())
        losses["D_B"] = lsgan(nets["D_B"](real_B), 1.0) + lsgan(nets["D_B"](fake_B), 0.0)
        losses["D_A"] = lsgan(nets["D_A"](real_A), 1.0) + lsgan(nets["D_A"](fake_A), 0.0)
        self.optimizers["D"].zero_grad(set_to_none=True)
        (losses["D_B"] + losses["D_A"]).backward()
        self._record(grads, ("D_B", "D_A"))
        if optimize:
            self.optimizers["D"].step()
        return {k: v.detach() for k, v in losses.items()}

    def _pooled(self, domain: str, fakes: torch.Tensor) -> torch.Tensor:
        """The pool works on channels-last images, as ganslate stores them."""
        cl = fakes.permute(0, *range(2, fakes.ndim), 1)
        return channels_first(self.pools[domain].query(cl))

    def _record(self, grads, names):
        if grads is None:
            return
        for n in names:
            for k, p in self.nets[n].named_parameters():
                grads[f"{n}.{k}"] = None if p.grad is None else p.grad.detach().clone()

    def parameters(self) -> Dict[str, torch.Tensor]:
        return {f"{n}.{k}": p for n, net in self.nets.items() for k, p in net.named_parameters()}

