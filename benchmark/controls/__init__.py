"""The controls that set the upper ends of the cells' limits, run on the
card: the reference put in the program's place at the precision below the
configuration's, and the faults a training cell can have."""
