"""Traffic drivers: the code that a traffic mix's ``driver`` names."""
