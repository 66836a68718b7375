"""CycleGAN dataset downloader (the JAX package's
`utils/cli/scripts/download_datasets.py`): urllib, and a message naming the
URL and the folder layout when the download fails, as it does without
network access."""

import os
import shutil
import urllib.request
import zipfile
from pathlib import Path

AVAILABLE_DATASETS = [
    "ae_photos", "apple2orange", "summer2winter_yosemite", "horse2zebra",
    "monet2photo", "cezanne2photo", "ukiyoe2photo", "vangogh2photo", "maps",
    "cityscapes", "facades", "iphone2dslr_flower", "mini", "mini_pix2pix",
    "mini_colorization",
]

URL_TEMPLATE = "https://people.eecs.berkeley.edu/~taesung_park/CycleGAN/datasets/{name}.zip"


def download(name: str, path: str) -> None:
    if name not in AVAILABLE_DATASETS:
        print(f"Unknown dataset '{name}'. Available: {', '.join(AVAILABLE_DATASETS)}")
        return

    assert Path(path).is_dir(), f"{path} provided is not a directory"
    url = URL_TEMPLATE.format(name=name)
    path_to_zip = f"{path}/{name}.zip"

    if os.path.isfile(path_to_zip):
        os.remove(path_to_zip)

    print(f"Fetching {name} dataset from {url}:")
    try:
        urllib.request.urlretrieve(url, path_to_zip)
    except OSError as e:
        print(f"Download failed ({e}). This environment may have no network "
              f"access; fetch {url} manually and unpack it to {path}/{name} "
              f"with train/A, train/B, test/A, test/B subfolders.")
        return

    if Path(f"{path}/{name}").is_dir():
        shutil.rmtree(Path(f"{path}/{name}"))

    print(f"Extracting zip file to {path}")
    with zipfile.ZipFile(path_to_zip, "r") as zip_ref:
        zip_ref.extractall(path)
    os.remove(path_to_zip)

    print("Reorganizing folder structure (train/A,B + test/A,B)")
    train_path = Path(f"{path}/{name}/train")
    test_path = Path(f"{path}/{name}/test")
    train_path.mkdir(parents=True, exist_ok=True)
    test_path.mkdir(parents=True, exist_ok=True)
    shutil.move(f"{path}/{name}/trainA", str(train_path / "A"))
    shutil.move(f"{path}/{name}/trainB", str(train_path / "B"))
    shutil.move(f"{path}/{name}/testA", str(test_path / "A"))
    shutil.move(f"{path}/{name}/testB", str(test_path / "B"))
