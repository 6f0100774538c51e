"""One driver per kind of traffic (a traffic file's ``kind``): it makes the
inputs from the seed, warms up, runs the window and judges what the program
produced."""
