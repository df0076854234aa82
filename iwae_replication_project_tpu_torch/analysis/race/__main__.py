"""``python -m iwae_replication_project_tpu_torch.analysis.race`` entry point."""

import sys

from iwae_replication_project_tpu_torch.analysis.race.cli import main

if __name__ == "__main__":
    sys.exit(main())
