"""Discriminator history buffer (the JAX package's
`ganslate_tpu/data/utils/image_pool.py`).

For each generated image in turn: while the pool holds fewer than
`pool_size` images, the image is stored and returned; once it is full, with
probability 1/2 the image is returned as it is, else a random stored image
is returned and replaced by the new one. `pool_size=0` is the identity.

The pool holds its images on the device, in the compute dtype. The two draws per image (a uniform, compared with 0.5, and an
index), made for every image as the JAX package makes them, come from a
host `torch.Generator`: the choices are host integers, so a query never
waits for the device.
"""

from typing import Optional, Sequence, Tuple

import torch


class ImagePool:
    """A pool of `pool_size` images of `image_shape` (channels-last, without
    the batch dim) in `dtype` on `device`."""

    def __init__(self, pool_size: int, image_shape: Tuple[int, ...],
                 dtype: torch.dtype = torch.float32, device: torch.device = None,
                 generator: Optional[torch.Generator] = None):
        self.pool_size = int(pool_size)
        self.generator = generator if generator is not None else torch.Generator()
        self.images = torch.zeros((self.pool_size, *image_shape), dtype=dtype, device=device)
        self.count = 0                                # images stored

    def draws(self, n: int) -> Sequence[Tuple[float, int]]:
        """`n` pairs (uniform in [0, 1), index in [0, pool_size))."""
        u = torch.rand(n, generator=self.generator)
        idx = torch.randint(self.pool_size, (n,), generator=self.generator)
        return list(zip(u.tolist(), idx.tolist()))

    def query(self, images: torch.Tensor,
              draws: Optional[Sequence[Tuple[float, int]]] = None) -> torch.Tensor:
        """Push a batch of generated images through the pool; returns the
        images the discriminator should see. `draws` (one `(uniform, index)`
        pair per image) replaces the generator's draws, for tests."""
        if self.pool_size == 0:
            return images
        images = images.detach().to(self.images.dtype)
        if draws is None:
            draws = self.draws(images.shape[0])
        returned = images.clone()
        for i, (u, idx) in enumerate(draws):
            if self.count < self.pool_size:
                self.images[self.count].copy_(images[i])
                self.count += 1
            elif u > 0.5:
                returned[i].copy_(self.images[idx])
                self.images[idx].copy_(images[i])
        return returned
