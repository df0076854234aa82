"""Framework-free helpers of the port: device resolution, dtypes, config."""
