"""Reference copies of the GAN loss terms."""
