"""CLI alias: ``python -m figbird_tpu_torch.cli Config.json`` ==
``python -m figbird_tpu_torch``."""

from .__main__ import main

if __name__ == "__main__":
    raise SystemExit(main())
