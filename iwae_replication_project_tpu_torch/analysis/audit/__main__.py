"""``python -m iwae_replication_project_tpu_torch.analysis.audit``."""

import sys

from iwae_replication_project_tpu_torch.analysis.audit.cli import main

if __name__ == "__main__":
    sys.exit(main())
