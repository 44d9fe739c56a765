import sys

from tpuserve_torch.provision.cli import main

if __name__ == "__main__":
    sys.exit(main())
