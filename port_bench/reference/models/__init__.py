"""Reference copies of the VISinger and HiFi-GAN models."""
