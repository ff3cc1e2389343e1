"""python -m prmers_tpu_torch: the command line of the CUDA port (app.main)."""
import sys

from .app import main

if __name__ == "__main__":
    sys.exit(main())
