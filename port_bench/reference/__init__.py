"""The benchmark's plain reference: PyTorch and NumPy, float32.

Frozen copies of the model code the benchmark's cells run (the VISinger
generator and discriminators, HiFi-GAN, the score front end, the
spectrogram and the GAN losses), plus a NumPy monotonic alignment search
(``mas.py``) and the plain glue of a batched score and a training step
(``pipeline.py``, ``train_step.py``). Nothing here imports the measured
package or JAX, and nothing takes a tensor the measured package made: the
harness makes the weights and inputs from the seed and hands the same to
both sides.
"""
