"""FAGP core of the port: mercer, expansions, fagp, gp, exact_gp, convert."""
