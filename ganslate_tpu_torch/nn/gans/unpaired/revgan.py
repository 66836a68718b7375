"""RevGAN (van der Ouderaa & Worrall, CVPR 2019; the JAX package's
`nn/gans/unpaired/revgan.py`).

One partially-invertible generator G, run forward for AB and inverted
(`inverse=True`) for BA; discriminators D_B and D_A; the cycle and identity
losses of CycleGAN; an image pool per fake domain; Adam groups {G} and
{D_B, D_A}. Infer mode builds G only, and `infer(direction="BA")` runs it
inverted (`BaseGAN.infer`).

The generator's adversarial loss pairs each fake with the discriminator of
its own domain, D_B(fake_B) and D_A(fake_A), as the JAX package does: the
original ganslate feeds D_B(fake_A) and D_A(fake_B), which disagrees with
its own D step. The shared core trains by recompute-by-inverse
(`nn/invertible.py`) when `use_memory_saving` is set; each of its four uses
in a step (fake_B, rec_A, fake_A, rec_B) is its own application, and
autograd sums their gradients into the one set of parameters. Spatially
sharded as the CycleGAN is, the memory-saving core included.
"""

from dataclasses import dataclass, field

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.gans.unpaired import cyclegan


@dataclass
class OptimizerConfig(cyclegan.OptimizerConfig):
    """RevGAN optimizer config: CycleGAN's knobs."""


@dataclass
class RevGANConfig(configs.base.BaseGANConfig):
    """RevGAN config."""
    pool_size: int = 50
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


class RevGAN(cyclegan.CycleGAN):

    def __init__(self, conf):
        super().__init__(conf)
        network_names = ["G", "D_B", "D_A"] if self.is_train else ["G"]
        self.networks = {name: None for name in network_names}
        self.network_groups = {"G": ["G"], "D": ["D_B", "D_A"]}

    def train_step(self):
        real_A, real_B = self._batch["A"], self._batch["B"]
        adv = self.criterion_adv
        opt_G = self.optimizers["G"]

        # ---- G update; the discriminators are frozen.
        with self.frozen(self.network_groups["D"]):
            params = self.compute_params(["G", "D_B", "D_A"])
            fake_B = self.apply("G", real_A, params, self.rng)
            rec_A = self.apply("G", fake_B, params, self.rng, inverse=True)
            fake_A = self.apply("G", real_B, params, self.rng, inverse=True)
            rec_B = self.apply("G", fake_A, params, self.rng)
            visuals = {"real_A": real_A, "fake_B": fake_B, "rec_A": rec_A,
                       "real_B": real_B, "fake_A": fake_A, "rec_B": rec_B}
            if self.criterion_G.is_using_identity():
                visuals["idt_B"] = self.apply("G", real_B, params, self.rng)
                visuals["idt_A"] = self.apply("G", real_A, params, self.rng, inverse=True)

            losses = {"G_AB": adv(self.apply("D_B", fake_B, params, self.rng),
                                  target_is_real=True),
                      "G_BA": adv(self.apply("D_A", fake_A, params, self.rng),
                                  target_is_real=True)}
            losses.update(self.criterion_G(visuals))
            opt_G.zero_grad(set_to_none=True)
            # Summed in sorted key order, as the JAX package's tree_leaves.
            sum(losses[k] for k in sorted(losses)).backward()
        self.step("G")
        visuals = {k: v.detach() for k, v in visuals.items()}
        return self.discriminator_step(losses, visuals)
