"""Operations and bytes the work needs, counted on the plain reference at
the inputs' own lengths, and the chip's published peaks."""
