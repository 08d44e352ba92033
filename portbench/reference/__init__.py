"""Plain PyTorch references of the configurations the benchmark runs. They
import nothing of the program under test and take nothing it made."""
