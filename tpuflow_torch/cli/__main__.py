import sys

from tpuflow_torch.cli.parser import main

if __name__ == "__main__":
    sys.exit(main())
