"""The harness of the port's benchmark: the runners of each traffic kind and the yardstick they share."""
