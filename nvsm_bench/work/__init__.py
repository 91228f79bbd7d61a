"""Operations and bytes of each configuration's work, by configuration name."""
