"""Online serving (port of ``serving/``): micro-batching engine, bucket
ladder, row-independent programs and metrics."""
