"""``python -m iwae_replication_project_tpu_torch.analysis`` entry point."""

import sys

from iwae_replication_project_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
