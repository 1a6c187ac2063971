"""`python -m trex_tpu_torch.cli` entry point."""

from trex_tpu_torch.cli.parser import main

if __name__ == "__main__":
    main()
