"""``python -m iwae_replication_project_tpu_torch``: the staged experiment
runner (:func:`.experiment.main`)."""

from iwae_replication_project_tpu_torch.experiment import main

if __name__ == "__main__":
    main()
