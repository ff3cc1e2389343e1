"""python -m prmers_tpu_torch — PRP / LL on the CUDA port."""
import sys

from .app import main

if __name__ == "__main__":
    sys.exit(main())
