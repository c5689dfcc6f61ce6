"""Reference copy of the spectrogram code the GAN losses use."""
