"""Plain PyTorch references of the benchmark's model families, one module
each (a configuration file names its module under ``reference``). They
import nothing of the program: they read the benchmark's drawn weights
(``bench.weights``) and compute in fp32 with TF32 off."""
