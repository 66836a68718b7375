"""A single domain directory of 2D images, decoded through Pillow (the JAX
package's `data/image_folder.py`).

Pillow is imported when a folder is opened, not when this module is: a
machine without it can import the data plane and run a dataset of its own,
and an image folder there fails with an error that names Pillow and the
folder.
"""

from pathlib import Path

from ganslate_tpu_torch.utils.io import make_dataset_of_files

IMAGE_EXTENSIONS = ['.jpg', '.jpeg', '.png']


def import_pil(what: str):
    """`PIL.Image`, or an ImportError that says what needed it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{what} needs Pillow (PIL), which is not installed") from e
    return Image


class ImageFolder:
    """Sorted image files under `root`, decoded as RGB or grayscale."""

    def __init__(self, root, image_channels: int):
        self.root = Path(root)
        self._image = import_pil(f"the image folder {self.root}")
        self.paths = make_dataset_of_files(self.root, IMAGE_EXTENSIONS)
        self.pil_mode = 'RGB' if image_channels == 3 else 'L'

    def __len__(self) -> int:
        return len(self.paths)

    def load(self, index: int):
        with self._image.open(self.paths[index]) as img:
            return img.convert(self.pil_mode)


def domain_folders(conf, *domains: str):
    """ImageFolders for the mode's dataset root, one per domain subdir."""
    dataset_conf = conf[conf.mode].dataset
    return tuple(ImageFolder(Path(dataset_conf.root) / d, dataset_conf.image_channels)
                 for d in domains)
