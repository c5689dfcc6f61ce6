"""Model zoo of the port: VISinger SVS and the melody transformer."""
