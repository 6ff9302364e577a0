import sys

from dmlc_tpu_torch.tools import main

if __name__ == "__main__":
    sys.exit(main())
