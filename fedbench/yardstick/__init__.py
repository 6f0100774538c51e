"""The yardstick: what later changes to the program cannot move. Peaks,
operation and byte counts, the Table-I scenario law, the system model that
judges an allocation, the logit comparison and the device trace reader."""
