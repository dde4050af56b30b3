"""The benchmark's harness: everything that is the yardstick and not the
program under test. Only ``bench.port`` imports the port (``repro_torch``);
every other module here is plain Python, numpy or torch."""
