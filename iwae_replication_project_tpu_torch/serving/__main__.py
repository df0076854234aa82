import sys

from iwae_replication_project_tpu_torch.serving.cli import main

if __name__ == "__main__":
    sys.exit(main())
