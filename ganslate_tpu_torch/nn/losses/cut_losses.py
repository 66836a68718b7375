"""PatchNCE contrastive loss of CUT (Park et al., ECCV 2020; the JAX
package's `ganslate_tpu/nn/losses/cut_losses.py`).

The positive logit of a patch is the dot product of its query and its key;
the negatives are the keys of every other patch of the same image (the
diagonal of the patch-by-patch product set to -10); cross-entropy at
temperature `nce_T` with the positive as class 0. Per-patch losses are
returned (the caller means them). The keys are detached and the loss runs
in fp32. The patch-by-patch product is a plain batched matrix product,
which the JAX package computes outside any kernel of its own. Data
parallel, the patches are this rank's share of the global batch: the
images are `train.batch_size` over the data ranks."""

import torch

from ganslate_tpu_torch.parallel import check_local_batch


class PatchNCELoss:

    def __init__(self, conf):
        self.batch_size = conf.train.batch_size
        self.nce_T = conf.train.gan.optimizer.nce_T

    def __call__(self, feat_q: torch.Tensor, feat_k: torch.Tensor) -> torch.Tensor:
        """feat_q, feat_k: `(B * P, C)` L2-normalised patch embeddings;
        returns the per-patch losses `(B * P,)`."""
        dim = feat_q.shape[1]
        feat_q = feat_q.float()
        feat_k = feat_k.detach().float()

        # Positive logits <q_i, k_i>.
        l_pos = (feat_q * feat_k).sum(dim=1, keepdim=True)

        # Negative logits: patch against patch within each image.
        images = check_local_batch(self.batch_size)
        q = feat_q.reshape(images, -1, dim)
        k = feat_k.reshape(images, -1, dim)
        num_patches = q.shape[1]
        l_neg = torch.bmm(q, k.transpose(1, 2))
        diagonal = torch.eye(num_patches, dtype=torch.bool, device=q.device)[None]
        l_neg = l_neg.masked_fill(diagonal, -10.0).reshape(-1, num_patches)

        logits = torch.cat([l_pos, l_neg], dim=1) / self.nce_T
        return -torch.log_softmax(logits, dim=1)[:, 0]
