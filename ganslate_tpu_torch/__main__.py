from ganslate_tpu_torch.utils.cli.interface import interface

if __name__ == "__main__":
    interface()
