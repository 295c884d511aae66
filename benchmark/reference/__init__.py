"""The benchmark's plain reference: the IoniqRE path tracer in plain PyTorch,
float32, with every seed, draw, camera ray and scene table worked out again
from the configuration and the seed. It imports nothing of the program
under test and takes nothing the program has made."""
