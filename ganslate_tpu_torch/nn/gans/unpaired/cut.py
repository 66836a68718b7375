"""CUT and FastCUT (Park et al., ECCV 2020; the JAX package's
`nn/gans/unpaired/cut.py`).

Networks G, D and `mlp`, a projection MLP per NCE level
(`FeaturePatchMLP`); Adam groups {G}, {D} and {mlp}, the last at lr_G. One
train step, in the JAX package's order:

1. FastCUT's flip (`use_equivariance_flip`): one draw from the model's
   generator `rng` flips real_A, and real_B under identity NCE, along W for
   the whole batch.
2. The D update on real_B and the detached fake_B = G(real_A).
3. The joint G + mlp update against the updated D: the adversarial loss
   times `lambda_adv`, plus PatchNCE between G's encoder taps of real_A and
   of fake_B at `nce_layers`, averaged over the levels, mixed with
   `lambda_nce_idt` times PatchNCE between real_B and idt_B = G(real_B).

Per level, one permutation of the tap's positions, drawn from `rng` and
shared between source and target and across the batch, picks
min(num_patches, positions) patches (`draw_patch_ids`); identity NCE makes
its own draw. The source's pool is the loss's detached key, so its tap pass
and its MLP run without a graph. Under a flip the target's taps are read at
the mirrored positions, which is the JAX package's flip of the target's
features back along W, without the copy. The flip stays on the device (a
`where`), so the step never waits for it.

fake_B is computed once: its detached value feeds the D update and its
graph the G update (the JAX package recomputes it; the numbers are the
same). G and D run under the compute-dtype policy (`BaseGAN.apply`); the
patch matrices and `mlp` are fp32. Infer mode builds G only, which
translates A to B only.

Spatially sharded (`train.spatial_mesh`), the taps are slabs along the
first spatial dim. The patch ids are drawn over the whole sample's
positions, and the ranks of a spatial group, whose `rng` is seeded alike
and draws the same sequence, draw the same ids. `select_patches` is then
the group's indexed select (`parallel.spatial.select`, site
'cut_patches'): every rank holds the whole `(B * P, C)` patch matrices,
and the MLP head and PatchNCE run replicated on them; the loss is each
rank's share (`spatial.global_mean`), so the group's sum of the MLP's
gradients, and of G's through the select's backward, counts each once."""

import logging
import math
from dataclasses import dataclass, field
from typing import Sequence, Tuple

import torch
from torch import nn

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.gans.base import BaseGAN
from ganslate_tpu_torch.nn.layers import make_initializer
from ganslate_tpu_torch.nn.losses.adversarial_loss import AdversarialLoss
from ganslate_tpu_torch.nn.losses.cut_losses import PatchNCELoss
from ganslate_tpu_torch.parallel import spatial
from ganslate_tpu_torch.utils.tracing import span

logger = logging.getLogger(__name__)


@dataclass
class OptimizerConfig(configs.base.BaseOptimizerConfig):
    """CUT optimizer config."""
    # Weight for adversarial loss Adv(G(X)).
    lambda_adv: float = 1
    # Weight for NCE loss NCE(G(X), X).
    lambda_nce: float = 1
    # Weight for identity-mapping NCE loss NCE(G(Y), Y), mixed with lambda_nce.
    lambda_nce_idt: float = 0.5
    # Temperature for NCE loss.
    nce_T: float = 0.07


@dataclass
class CUTConfig(configs.base.BaseGANConfig):
    """CUT config."""
    # Encoder layers for the NCE loss; 0 denotes the (padded) input itself.
    nce_layers: Tuple[int] = (0, 4, 8, 12, 16)
    # Width of the projection MLP.
    mlp_nc: int = 256
    # Number of patches per layer.
    num_patches: int = 256
    # Flip-equivariance regularization (FastCUT uses it, CUT does not).
    use_equivariance_flip: bool = False
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


class FeaturePatchMLP(nn.Module):
    """Per NCE level: Linear(C_l -> nc), ReLU, Linear(nc -> nc), then L2
    normalisation (+1e-7). The layers carry the JAX package's names
    (`mlp{i}_fc1`, `mlp{i}_fc2`); weights are drawn from the init menu in
    the JAX `(in, out)` layout and stored as `(out, in)`, biases are zero.
    It acts on each patch's row alone, replicated under spatial sharding."""

    spatially_sharded = True

    def __init__(self, channels_per_feature: Sequence[int], nc: int = 256,
                 weight_init_type: str = "normal", weight_init_gain: float = 0.02,
                 generator: torch.Generator = None):
        super().__init__()
        init = make_initializer(weight_init_type, weight_init_gain)
        for i, channels in enumerate(channels_per_feature):
            for name, n_in in ((f"mlp{i}_fc1", channels), (f"mlp{i}_fc2", nc)):
                layer = nn.Linear(n_in, nc)
                with torch.no_grad():
                    layer.weight.copy_(init((n_in, nc), generator).t())
                    layer.bias.zero_()
                setattr(self, name, layer)

    def forward(self, feats):
        """feats: a list of `(P, C_l)` patch matrices; returns the list of
        their `(P, nc)` L2-normalised embeddings."""
        out = []
        for i, feat in enumerate(feats):
            h = getattr(self, f"mlp{i}_fc2")(torch.relu(getattr(self, f"mlp{i}_fc1")(feat)))
            out.append(h / (h.square().sum(dim=-1, keepdim=True).sqrt() + 1e-7))
        return out


def draw_flip(generator: torch.Generator) -> torch.Tensor:
    """FastCUT's flip: a 0-d bool tensor on the generator's device, true with
    probability 1/2."""
    return torch.rand((), generator=generator, device=generator.device) < 0.5


def draw_patch_ids(generator: torch.Generator, positions: int, num_patches: int):
    """The first min(num_patches, positions) entries of a random
    permutation of a tap's `positions`, on the generator's device."""
    perm = torch.randperm(positions, generator=generator, device=generator.device)
    return perm[:min(num_patches, positions)]


def positions(feat) -> int:
    """The whole sample's positions of a tap `(B, *spatial, C)`: a sharded
    tap's slab holds 1/size of them."""
    scope = spatial.active()
    return math.prod(feat.shape[1:-1]) * (scope.size if scope is not None else 1)


def select_patches(feats, patch_ids):
    """Taps `(B, *spatial, C)` at the shared positions `patch_ids`, as fp32
    `(B * P, C)` patch matrices. For a channels-last tap the flattening is a
    view. Spatially sharded, the ids are the whole sample's positions and
    every rank gets the whole matrices (`spatial.select`)."""
    scope = spatial.active()
    out = []
    for f, ids in zip(feats, patch_ids):
        flat = f.reshape(f.shape[0], -1, f.shape[-1])
        if scope is None:
            out.append(flat.index_select(1, ids).reshape(-1, f.shape[-1]).float())
        else:
            out.append(spatial.select(flat, ids, scope, site="cut_patches")
                       .reshape(-1, f.shape[-1]))
    return out


def mirror_w(ids: torch.Tensor, width: int) -> torch.Tensor:
    """Flat positions of a `(*spatial)` grid mirrored along its last axis
    (W, of extent `width`). W is never the sharded dim (spatial dim 0, H of
    an image, D of a volume), so a mirrored position stays in its slab and
    the whole sample's flat positions mirror as the slab's do."""
    w = ids % width
    return ids + (width - 1) - 2 * w


class CUT(BaseGAN):

    spatially_sharded = True

    def __init__(self, conf):
        super().__init__(conf)
        if self.is_train:
            gan_conf = conf.train.gan
            optimizer_conf = gan_conf.optimizer
            self.lambda_adv = optimizer_conf.lambda_adv
            self.lambda_nce = optimizer_conf.lambda_nce
            self.lambda_nce_idt = optimizer_conf.lambda_nce_idt
            self.nce_layers = tuple(gan_conf.nce_layers)
            self.num_patches = gan_conf.num_patches
            self.use_equivariance_flip = gan_conf.use_equivariance_flip
        network_names = ["G", "D", "mlp"] if self.is_train else ["G"]
        self.networks = {name: None for name in network_names}
        self.network_groups = {"G": ["G"], "D": ["D"], "mlp": ["mlp"]}

    # -------------------------------------------------------------- networks

    def build_network(self, name, generator):
        """`mlp`, after G: `nce_layers` trimmed to G's taps, with a warning
        (the original silently truncated them through a zip), and one MLP
        block per level of the width of its tap."""
        if name != "mlp":
            return super().build_network(name, generator)
        max_levels = getattr(self.networks["G"], "num_feature_levels", None)
        if max_levels is not None:
            valid = tuple(level for level in self.nce_layers if level < max_levels)
            if valid != self.nce_layers:
                logger.warning(f"nce_layers {self.nce_layers} exceed the generator's "
                               f"{max_levels} feature taps; using {valid}.")
                self.nce_layers = valid
        gan_conf = self.conf.train.gan
        return FeaturePatchMLP(self.feature_channels(), gan_conf.mlp_nc,
                               gan_conf.weight_init_type, gan_conf.weight_init_gain, generator)

    def feature_channels(self) -> Tuple[int, ...]:
        """The channels of G's taps at `nce_layers`, from one tap call of a
        copy of G built on the CPU at the JAX package's probe size, so that
        nothing runs on the card."""
        from ganslate_tpu_torch.utils.builders import build_G
        probe = build_G(self.conf, "AB", torch.Generator())
        in_channels = int(self.conf.train.gan.generator.in_out_channels.AB[0])
        spatial = (16, 64, 64) if getattr(probe, "spatial_dims", 2) == 3 else (64, 64)
        with torch.no_grad():
            feats = probe(torch.zeros(1, in_channels, *spatial),
                          extract_features=list(self.nce_layers))
        return tuple(int(f.shape[1]) for f in feats)

    # ----------------------------------------------------------- components

    def init_criterions(self):
        self.criterion_adv = AdversarialLoss(
            self.conf.train.gan.optimizer.adversarial_loss_type)
        self.criterion_nce = PatchNCELoss(self.conf)

    def init_optimizers(self):
        optimizer_conf = self.conf.train.gan.optimizer
        self.optimizers = {"G": self.make_adam("G", optimizer_conf.lr_G),
                           "D": self.make_adam("D", optimizer_conf.lr_D),
                           "mlp": self.make_adam("mlp", optimizer_conf.lr_G)}

    def init_pools(self, example_batch):
        self.pools = {}

    def _stochastic(self) -> bool:
        """The train step draws its patch ids (and flip) from `rng`."""
        return True

    # -------------------------------------------------------- the train step

    def nce_loss(self, params, source, target, flip):
        """PatchNCE between G's taps of `source` (the keys) and of `target`
        (the queries), times `lambda_nce`, averaged over the levels. `flip`
        (a 0-d bool tensor, or None) reads the target's taps mirrored along
        W."""
        layers = list(self.nce_layers)
        mlp = self.networks["mlp"]
        with torch.no_grad():
            feats_k = self.apply("G", source, params, extract_features=layers)
            patch_ids = [draw_patch_ids(self.rng, positions(f), self.num_patches)
                         for f in feats_k]
            with span("ganslate.forward.mlp"):
                pool_k = mlp(select_patches(feats_k, patch_ids))
        del feats_k
        feats_q = self.apply("G", target, params, extract_features=layers)
        if flip is not None:
            patch_ids = [torch.where(flip, mirror_w(ids, f.shape[-2]), ids)
                         for ids, f in zip(patch_ids, feats_q)]
        with span("ganslate.forward.mlp"):
            pool_q = mlp(select_patches(feats_q, patch_ids))
        total = 0.0
        for q, k in zip(pool_q, pool_k):
            total = total + spatial.global_mean(self.criterion_nce(q, k)) * self.lambda_nce
        return total / len(layers)

    def train_step(self):
        real_A, real_B = self._batch["A"], self._batch["B"]
        adv = self.criterion_adv
        use_idt = self.lambda_nce_idt > 0

        # ---- FastCUT's flip along W, of the whole batch (W is never the
        # sharded dim: each slab flips in place).
        flip = None
        if self.use_equivariance_flip:
            flip = draw_flip(self.rng)
            real_A = torch.where(flip, real_A.flip(-2), real_A)
            if use_idt:
                real_B = torch.where(flip, real_B.flip(-2), real_B)

        # ---- D update first, on the detached fake.
        params = self.compute_params(["G"])
        fake_B = self.apply("G", real_A, params)
        params_D = self.compute_params(["D"])
        pred_real, pred_fake = self.apply_batched("D", [real_B, fake_B.detach()], params_D)
        loss_D = adv(pred_real, True) + adv(pred_fake, False)
        self.backward(loss_D, "D")
        self.step("D")

        # ---- Joint G + mlp update against the updated D, which is frozen.
        with self.frozen(["D"]):
            if params is not None:
                params.update(self.compute_params(["D"]))
            idt_B = self.apply("G", real_B, params) if use_idt else None
            losses, total = {}, 0.0
            if self.lambda_adv > 0:
                losses["G"] = adv(self.apply("D", fake_B, params), True) * self.lambda_adv
                total = total + losses["G"]
            if self.lambda_nce > 0:
                loss_nce = self.nce_loss(params, real_A, fake_B, flip)
                losses["NCE"] = loss_nce
                if use_idt:
                    loss_nce_idt = self.lambda_nce_idt * self.nce_loss(params, real_B, idt_B,
                                                                       flip)
                    losses["NCE_idt"] = loss_nce_idt
                    loss_nce = (1 - self.lambda_nce_idt) * loss_nce + loss_nce_idt
                total = total + loss_nce
            self.backward(total, "G", "mlp")
        self.step("G", "mlp")

        visuals = {"real_A": real_A, "fake_B": fake_B.detach(), "real_B": real_B}
        if use_idt:
            visuals["idt_B"] = idt_B.detach()
        with torch.no_grad():
            metrics = self.training_metrics.compute_metrics_G(visuals)
            metrics.update(self.training_metrics.compute_metrics_D("D", pred_real, pred_fake))
        losses = {k: v.detach() for k, v in {"D": loss_D, **losses}.items()}
        return losses, visuals, metrics

    def infer(self, x, direction="AB", **kwargs):
        if direction != "AB":
            raise ValueError(f"CUT only translates A->B, got direction {direction!r}.")
        return super().infer(x, direction, **kwargs)
