"""Model zoo of the port: VISinger SVS, the melody transformer and the
T5 / GPT-2 lyric LMs."""
